"""The plain reference against the port's CPU route at tiny sizes, and
the reference's own pieces against their definitions."""

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench.catalog import HERE
from portbench.gen import seeded
from portbench.gen import wire as wire_gen
from portbench.reference import blob_feed, cdc, merkle

CHUNKING = json.loads((HERE / "configs" / "content-import.json")
                      .read_text())["chunking"]


def test_blob_feed_digests_equal_the_ports_digest_decoder():
    import dat_replication_protocol_tpu_torch as protocol

    w = wire_gen.make_session({"blobs": 3, "blob_bytes": 2048,
                               "changes_per_blob": 4,
                               "value_bytes": [40, 200]}, seed=11)
    want = blob_feed.expected_digests(w)
    got = {"change": [], "blob": []}
    dec = protocol.decode(backend="cuda", device="cpu")
    dec.on_digest(lambda kind, seq, d: got[kind].append(d))
    dec.write(w.buf.tobytes())
    dec.end()
    assert dec.finished and got == want


@pytest.mark.parametrize("n", [1, 63, 64, 65, 5000])
def test_gear_candidates_by_doubling_equal_the_byte_chain(n):
    buf = seeded.random_bytes(n, seed=n, stream=1)
    table = cdc.gear_table().tolist()
    h, want = 0, []
    for _ in range(cdc.WINDOW):
        h = ((h << 1) + table[0]) & (2**64 - 1)
    for j, b in enumerate(buf.tolist()):
        h = ((h << 1) + table[b]) & (2**64 - 1)
        if (h >> 32) & 0xFF == 0:
            want.append(j)
    assert cdc.candidates(buf, 8, "cpu").tolist() == want


def test_gear_candidates_across_blocks(monkeypatch):
    buf = seeded.random_bytes(50_000, seed=3, stream=1)
    whole = cdc.candidates(buf, 6, "cpu")
    monkeypatch.setattr(cdc, "BLOCK", 4096)
    assert np.array_equal(cdc.candidates(buf, 6, "cpu"), whole)


@pytest.mark.parametrize("n", [1, 2048, 100_000, 300_001])
def test_content_summary_equals_the_ports_cpu_route(n):
    from dat_replication_protocol_tpu_torch import content_address

    buf = seeded.random_bytes(n, seed=n, stream=4)
    s = content_address(buf, device="cpu")
    cuts, digests, root = cdc.summary(buf, CHUNKING, "cpu")
    assert s.cuts == cuts
    assert np.array_equal(s.digests, digests)
    assert s.root == root


def test_greedy_cuts_follow_the_rule():
    cands = np.array([10, 50, 51, 300, 310, 900], dtype=np.int64)
    assert cdc.greedy(cands, 1000, 40, 200) == [50, 250, 300, 500, 700, 900,
                                                 1000]
    assert cdc.thin(cands, 6).tolist() == [10, 300, 900]


def test_merkle_root_pads_with_zero_digests():
    d = [hashlib.blake2b(bytes([i]), digest_size=32).digest()
         for i in range(3)]

    def h(a, b):
        return hashlib.blake2b(a + b, digest_size=32).digest()

    assert merkle.root([]) == b"\0" * 32
    assert merkle.root(d[:1]) == d[0]
    assert merkle.root(d) == h(h(d[0], d[1]), h(d[2], b"\0" * 32))


def test_reference_runs_on_the_card_as_on_the_cpu(card):
    buf = seeded.random_bytes(3 << 20, seed=1, stream=4)
    assert np.array_equal(cdc.candidates(buf, 13, card),
                          cdc.candidates(buf, 13, torch.device("cpu")))


test_reference_runs_on_the_card_as_on_the_cpu = pytest.mark.cuda(
    test_reference_runs_on_the_card_as_on_the_cpu)
