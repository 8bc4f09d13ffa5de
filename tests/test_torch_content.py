"""The port's content addressing against the JAX package and hashlib.

Blobs are made with numpy from a seed.  On this CPU host the JAX
package's ``content_address`` takes its native host route and the port
runs its plain versions (``device="cpu"``); both must give the same
cuts, digests and root, field for field.  Summaries cross between the
packages through ``weights.summary_from_numpy``.  Comparisons are exact.
"""

import hashlib

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.batch import feed as jfeed
from dat_replication_protocol_tpu.ops import merkle as jmerkle
from dat_replication_protocol_tpu.runtime import content as jcontent
from dat_replication_protocol_tpu_torch import weights
from dat_replication_protocol_tpu_torch.batch import feed
from dat_replication_protocol_tpu_torch.ops import merkle
from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
    content_begin,
    pack_extents_device,
)
from dat_replication_protocol_tpu_torch.runtime import content


def _data(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _hashlib(buf: bytes, offs, lens) -> list[bytes]:
    return [hashlib.blake2b(buf[o:o + n], digest_size=32).digest()
            for o, n in zip(np.asarray(offs).tolist(),
                            np.asarray(lens).tolist())]


def _as_jax(s):
    return jcontent.ContentSummary(*weights.summary_to_numpy(s))


def _as_port(s):
    return weights.summary_from_numpy(s.length, s.cuts, s.digests, s.root)


EXTENTS = [
    (np.array([0, 130, 1024, 2049]), np.array([130, 894, 1025, 777])),
    (np.arange(0, 5000, 50), np.full(100, 50)),
    (np.array([7]), np.array([0])),
]


@pytest.mark.parametrize("offs,lens", EXTENTS, ids=["ragged", "uniform",
                                                    "empty-item"])
def test_pack_ragged_matches_jax(offs, lens):
    buf = np.frombuffer(_data(5000, 41), dtype=np.uint8)
    for got, want in zip(feed.pack_ragged(buf, offs, lens, 16),
                         jfeed.pack_ragged(buf, offs, lens, 16)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert {k: v.tolist() for k, v in feed.bucketed_extents(lens).items()} \
        == {k: v.tolist() for k, v in jfeed.bucketed_extents(lens).items()}


def test_pack_extents_device_matches_pack_ragged():
    buf = np.frombuffer(_data(5000, 42), dtype=np.uint8)
    offs, lens = EXTENTS[0]
    staged = np.zeros(5000 + 8, dtype=np.uint8)
    staged[:5000] = buf
    data = torch.from_numpy(staged)
    mh, ml, blens = pack_extents_device(data, offs, lens, 16)
    want = jfeed.pack_ragged(buf, offs, lens, 16)
    assert np.array_equal(mh.numpy().view(np.uint32), want[0])
    assert np.array_equal(ml.numpy().view(np.uint32), want[1])
    assert np.array_equal(blens.numpy().view(np.uint32), want[2])


def test_pack_extents_device_refuses_positions_past_the_cap():
    data = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="RESIDENCY_CAP"):
        pack_extents_device(data, [(1 << 31) - 1000], [10], 16)


@pytest.mark.parametrize("offs,lens", EXTENTS[:2], ids=["ragged", "uniform"])
def test_hash_extents_match_hashlib(offs, lens):
    raw = _data(5000, 43)
    buf = np.frombuffer(raw, dtype=np.uint8)
    got = feed.hash_extents(buf, offs, lens, device="cpu",
                            pipeline_bytes=4096)
    assert [bytes(d) for d in got] == _hashlib(raw, offs, lens)
    assert feed.hash_extents(buf, [], [], device="cpu").shape == (0, 32)


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_pad_leaves_and_root_match_root_host(n):
    leaves = [hashlib.blake2b(bytes([i]), digest_size=32).digest()
              for i in range(n)]
    hh, hl = merkle.pad_leaves(*merkle.digests_to_device(leaves,
                                                         device="cpu"))
    assert hh.shape[0] == 1 << (n - 1).bit_length()
    got = merkle.digests_from_device(*merkle.root(hh, hl))[0]
    matrix = np.frombuffer(b"".join(leaves), np.uint8).reshape(-1, 32)
    assert got == jmerkle.root_host(matrix) == merkle.root_host(leaves)


def test_unpack_mask_matches_jax():
    words = np.random.default_rng(9).integers(0, 1 << 32, 5,
                                              dtype=np.uint64).astype(
                                                  np.uint32)
    assert np.array_equal(merkle.unpack_mask(words.view(np.int32), 150),
                          jmerkle.unpack_mask(words, 150))


@pytest.mark.parametrize("n,seed,avg_bits", [
    (1 << 18, 0, 10),
    (1 << 17, 3, 10),
    (1 << 16, 7, 10),
    (100_003, 9, 8),
    (1, 1, 13),
], ids=["256k", "128k", "64k", "ragged-8", "one-byte"])
def test_content_address_matches_jax(n, seed, avg_bits):
    data = _data(n, seed)
    got = content.content_address(data, avg_bits=avg_bits, device="cpu")
    want = jcontent.content_address(data, avg_bits=avg_bits)
    assert got.length == want.length == n
    assert got.cuts == want.cuts
    assert np.array_equal(got.digests, want.digests)
    assert got.root == want.root
    assert _as_port(want) == got and _as_jax(got) == want


@pytest.mark.parametrize("route", ["first", "fused", "fused1p"])
def test_content_address_routes_agree(route):
    data = _data(1 << 16, 5)
    base = content.content_address(data, avg_bits=10, device="cpu")
    other = content.content_address(data, avg_bits=10, route=route,
                                     device="cpu")
    assert other == base and np.array_equal(other.digests, base.digests)


@pytest.mark.parametrize("route", ["fused1p", "2p"])
def test_content_digests_match_jax(route):
    data = np.frombuffer(_data(150_000, 31), dtype=np.uint8)
    cuts, digs = content.content_digests(data, avg_bits=10, route=route,
                                         device="cpu")
    jcuts, jdigs = jcontent.content_digests(data, avg_bits=10)
    assert cuts == jcuts and np.array_equal(digs, jdigs)


def test_delta_across_packages_and_reassemble():
    data = _data(1 << 18, seed=5)
    edited = data[:1000] + b"INSERTED-BYTES" * 8 + data[1000:]
    old = content.content_address(data, avg_bits=10, device="cpu")
    new = content.content_address(edited, avg_bits=10, device="cpu")
    jold = jcontent.content_address(data, avg_bits=10)
    jnew = jcontent.content_address(edited, avg_bits=10)
    d = content.delta(_as_port(jold), new)
    assert d == jcontent.delta(jold, _as_jax(new)) == jcontent.delta(jold,
                                                                     jnew)
    assert 1 <= len(d) <= 4
    offs, lens = new.extents()
    sent = {i: edited[int(offs[i]):int(offs[i] + lens[i])] for i in d}
    assert content.reassemble(new, data, old, sent) == edited
    assert content.delta(old, old) == []


def test_reassemble_rejects_corrupt_chunk():
    data = _data(1 << 16, seed=7)
    edited = data + b"tail-change"
    old = content.content_address(data, avg_bits=10, device="cpu")
    new = content.content_address(edited, avg_bits=10, device="cpu")
    d = content.delta(old, new)
    offs, lens = new.extents()
    sent = {i: edited[int(offs[i]):int(offs[i] + lens[i])] for i in d}
    sent[d[0]] = b"X" + sent[d[0]][1:]
    with pytest.raises(ValueError, match="digest mismatch"):
        content.reassemble(new, data, old, sent)


def test_empty_input():
    s = content.content_address(b"", device="cpu")
    assert s.nchunks == 0 and s.length == 0 and s.root == b"\0" * 32
    assert content.content_digests(b"", device="cpu")[0] == []
    assert content.delta(s, content.content_address(b"", device="cpu")) \
        == []


def test_content_begin_returns_device_digests():
    buf = np.frombuffer(_data(50_000, 12), dtype=np.uint8)
    cuts, hh, hl = content_begin(buf, avg_bits=10, device="cpu")()
    assert hh.dtype == torch.int32 and hh.shape == (len(cuts), 4)
    offs, lens = content._extents_from_cuts(cuts)
    assert merkle.digests_from_device(hh, hl) == _hashlib(buf.tobytes(),
                                                           offs, lens)


def test_summary_round_trip_bit_for_bit():
    s = content.content_address(_data(1 << 15, 2), avg_bits=9, device="cpu")
    length, cuts, digests, root = weights.summary_to_numpy(s)
    back = weights.summary_from_numpy(length, cuts, digests, root)
    assert back == s and np.array_equal(back.digests, s.digests)
    with pytest.raises(ValueError, match="one 32-byte digest per cut"):
        weights.summary_from_numpy(length, cuts[:-1], digests, root)


def test_unknown_content_routes_are_refused():
    with pytest.raises(ValueError, match="unknown content route"):
        content.content_digests(b"abc", route="bitmask", device="cpu")
    with pytest.raises(ValueError, match="unknown CDC route"):
        content.content_address(b"abc", route="2p", device="cpu")
