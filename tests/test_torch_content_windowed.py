"""``hash_extents`` from uploaded windows of the host buffer.

Extents, in offset order, are grouped into windows of at most
``feed.WINDOW_BYTES`` that end where an extent ends; each window's bytes
are staged once and its extents gathered and hashed on the device.  The
window is lowered here so that a small buffer spans many of them, and
the digests must equal ``hashlib``'s and the JAX package's
``hash_extents`` at every window edge: at a cut, across a chunk longer
than a window, with one window, one chunk or none, for a blob whose
length is not a multiple of 4, and for extents out of order, with gaps,
overlapping or empty.

With the cap lowered as in ``test_torch_content_slabbed.py``,
``content_address`` and ``content_digests``' two-pass route equal the
JAX package and never reach ``feed.pack_ragged``; ``extents.windows``
counts the windows, ``device.h2d.bytes`` the blob about once, and a CPU
``torch.profiler`` capture holds one ``extents.window`` a window and one
``extents.collect`` a call.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from dat_replication_protocol_tpu.batch import feed as jax_feed
from dat_replication_protocol_tpu.ops import fused_cdc_hash_pallas as jax_fch
from dat_replication_protocol_tpu.runtime import content as jax_content
from dat_replication_protocol_tpu_torch.batch import feed
from dat_replication_protocol_tpu_torch.obs import metrics
from dat_replication_protocol_tpu_torch.ops import fused_cdc_hash
from dat_replication_protocol_tpu_torch.runtime import content

CAP = 1 << 20
WINDOW = 256 << 10
BLOB = np.frombuffer(np.random.default_rng(2020).bytes(3 << 20),
                     dtype=np.uint8)


def _rng_bytes(n: int, seed: int) -> np.ndarray:
    return np.frombuffer(np.random.default_rng(seed).bytes(n),
                         dtype=np.uint8)


def _random_cuts(n: int, k: int, seed: int) -> list[int]:
    inner = np.random.default_rng(seed).choice(np.arange(1, n), k,
                                               replace=False)
    return sorted(inner.tolist()) + [n]


def _windows(cuts, window: int) -> int:
    """Windows of the greedy grouping, walked chunk by chunk: a chunk
    opens a window when the open one would pass ``window`` bytes."""
    n, start, prev = 0, None, 0
    for end in cuts:
        if start is None or end - start > window:
            n, start = n + 1, prev
        prev = end
    return n


def _hashlib(buf: np.ndarray, cuts) -> list[bytes]:
    starts = [0] + list(cuts[:-1])
    return [hashlib.blake2b(buf[a:b].tobytes(), digest_size=32).digest()
            for a, b in zip(starts, cuts)]


def _extents(cuts) -> tuple[np.ndarray, np.ndarray]:
    ends = np.asarray(cuts, dtype=np.int64)
    offs = np.concatenate([np.zeros(1, np.int64), ends[:-1]])[:len(ends)]
    return offs, ends - offs


@pytest.fixture
def gate_on():
    was = metrics.OBS.on
    metrics.REGISTRY.reset()
    metrics.enable()
    try:
        yield metrics.REGISTRY
    finally:
        metrics.OBS.on = was
        metrics.REGISTRY.reset()


@pytest.fixture
def no_host_pack(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the slabbed route packed on the host")

    monkeypatch.setattr(feed, "pack_ragged", refuse)


# (blob length, cuts or a seed for random ones, window bytes)
CASES = {
    "edges-at-cuts": (640, [128, 256, 384, 512, 640], 256),
    "chunk-longer-than-window": (1000, [10, 700, 720, 1000], 128),
    "single-window": (5000, 7, 1 << 20),
    "length-not-a-multiple-of-4": (1003, 11, 100),
    "one-chunk": (777, [777], 256),
    "one-short-chunk": (100, [100], 256),
    "no-cuts": (64, [], 256),
    "many-windows": (64 << 10, 13, 4 << 10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_hash_matches_hashlib_and_hash_extents(case, monkeypatch,
                                                        gate_on):
    n, cuts, window = CASES[case]
    buf = _rng_bytes(n, len(case))
    if isinstance(cuts, int):
        cuts = _random_cuts(n, max(1, n // 200), cuts)
    monkeypatch.setattr(feed, "WINDOW_BYTES", window)
    offs, lens = _extents(cuts)
    got = feed.hash_extents(buf, offs, lens, device="cpu")
    windows = _windows(cuts, window)
    assert gate_on.counter("extents.windows").value == windows
    # each window's bytes once, rounded up to whole words
    h2d = gate_on.counter("device.h2d.bytes").value
    covered = cuts[-1] if cuts else 0
    assert covered <= h2d < covered + 4 * windows or h2d == covered == 0
    assert got.shape == (len(cuts), 32) and got.dtype == np.uint8
    assert [d.tobytes() for d in got] == _hashlib(buf, cuts)
    if cuts:
        assert np.array_equal(got, jax_feed.hash_extents(buf, offs, lens))


# extents of a 4 KiB buffer that do not tile it, and the window's bytes
SPARSE = {
    "out-of-order": ([3000, 0, 1500, 700], [900, 700, 1500, 10], 1024),
    "gaps": ([0, 400, 2000, 4000], [100, 1000, 1900, 96], 1024),
    "overlapping": ([0, 10, 10, 500, 0], [4096, 20, 600, 100, 1], 700),
    "empty-extents": ([0, 4096, 100, 100], [0, 0, 300, 0], 128),
    "one-byte-windows": ([5, 1, 3], [1, 1, 1], 1),
}


@pytest.mark.parametrize("case", list(SPARSE))
def test_windowed_hash_of_extents_that_do_not_tile(case, monkeypatch,
                                                   gate_on):
    offs, lens, window = SPARSE[case]
    buf = _rng_bytes(4096, len(case) + 100)
    monkeypatch.setattr(feed, "WINDOW_BYTES", window)
    got = feed.hash_extents(buf, offs, lens, device="cpu")
    assert [d.tobytes() for d in got] == [
        hashlib.blake2b(buf[o:o + n].tobytes(), digest_size=32).digest()
        for o, n in zip(offs, lens)]
    assert np.array_equal(got, jax_feed.hash_extents(buf, offs, lens))
    assert gate_on.counter("extents.windows").value >= 1


@pytest.fixture(scope="module")
def reference():
    """The JAX package's summary, under the real cap."""
    return jax_content.content_address(BLOB)


@pytest.fixture
def capped(monkeypatch, reference):
    monkeypatch.setattr(fused_cdc_hash, "RESIDENCY_CAP", CAP)
    monkeypatch.setattr(jax_fch, "RESIDENCY_CAP", CAP)
    monkeypatch.setattr(feed, "WINDOW_BYTES", WINDOW)


def test_slabbed_content_address_hashes_from_windows(capped, reference,
                                                     no_host_pack, gate_on):
    got = content.content_address(BLOB, device="cpu")
    jax_capped = jax_content.content_address(BLOB)
    for want in (reference, jax_capped):
        assert got.cuts == want.cuts and got.root == want.root
        assert np.array_equal(got.digests, want.digests)
    assert [d.tobytes() for d in got.digests] == _hashlib(BLOB, got.cuts)
    windows = _windows(got.cuts, WINDOW)
    assert windows >= len(BLOB) // WINDOW
    assert gate_on.counter("extents.windows").value == windows
    h2d = gate_on.counter("device.h2d.bytes").value
    assert len(BLOB) <= h2d < len(BLOB) + 4 * windows


@pytest.mark.parametrize("route", ["2p", "fused1p"])
def test_slabbed_content_digests_hash_from_windows(route, capped, reference,
                                                   no_host_pack, gate_on):
    cuts, digests = content.content_digests(BLOB, route=route, device="cpu")
    jcuts, jdigests = jax_content.content_digests(BLOB, route=route)
    assert cuts == jcuts == reference.cuts
    assert np.array_equal(digests, jdigests)
    assert np.array_equal(digests, reference.digests)
    assert gate_on.counter("extents.windows").value == _windows(cuts,
                                                                 WINDOW)


def test_two_pass_route_under_the_cap_hashes_from_one_window(
        no_host_pack, gate_on):
    """Under the cap the ``"2p"`` route is the two-pass one too."""
    buf = BLOB[:200_000]
    cuts, digests = content.content_digests(buf, route="2p", device="cpu")
    assert [d.tobytes() for d in digests] == _hashlib(buf, cuts)
    assert gate_on.counter("extents.windows").value == 1


def test_one_window_span_a_window_and_one_collect_a_call(monkeypatch):
    # a capture records every torch op of the CPU plain B1, a few
    # thousand a launch: a 4 KiB blob of one-block chunks keeps it short
    monkeypatch.setattr(fused_cdc_hash, "RESIDENCY_CAP", 1 << 10)
    monkeypatch.setattr(feed, "WINDOW_BYTES", 512)
    blob = BLOB[:4 << 10]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = content.content_address(blob, avg_bits=6, min_size=32,
                                      max_size=128, device="cpu")
    assert [d.tobytes() for d in got.digests] == _hashlib(blob, got.cuts)
    names = [e.name for e in prof.events()]
    assert names.count("extents.window") == _windows(got.cuts, 512) > 1
    assert "extents.pack" not in names
    assert names.count("extents.collect") == 1
