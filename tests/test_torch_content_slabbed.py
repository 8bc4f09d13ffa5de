"""``content_address`` above ``RESIDENCY_CAP``: the slabbed route.

A blob at or above the cap is cut by ``chunk_stream`` slab by slab,
hashed from the host buffer by ``feed.hash_extents`` and folded by
``root_host`` (the port's ``runtime/content.py``, the JAX package's
``content_digests`` device branch).  Both packages read the cap at call
time, so it is set to 1 MiB in both modules and a seeded 3 MiB blob
takes that route on every extraction route of the port (``device="cpu"``:
the plain versions).  On this CPU host the JAX package serves the blob
on its host engines, whose cuts, digests and root the device routes
equal.  Cuts, digests and the root must be equal, field for field, to
the JAX package's, to ``hashlib`` and to the single-residency route of
the same blob under the real cap.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from dat_replication_protocol_tpu.ops import fused_cdc_hash_pallas as jax_fch
from dat_replication_protocol_tpu.runtime import content as jax_content
from dat_replication_protocol_tpu_torch.obs import device, events, metrics
from dat_replication_protocol_tpu_torch.ops import fused_cdc_hash, merkle
from dat_replication_protocol_tpu_torch.ops.rabin import ROUTES
from dat_replication_protocol_tpu_torch.runtime import content

CAP = 1 << 20
BLOB = np.frombuffer(np.random.default_rng(2020).bytes(3 << 20),
                     dtype=np.uint8)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's summary and the port's single-residency one."""
    want = jax_content.content_address(BLOB)
    single = content.content_address(BLOB, device="cpu")
    return want, single


@pytest.fixture
def capped(monkeypatch, reference):
    # the references are taken under the real cap, before it is lowered
    monkeypatch.setattr(fused_cdc_hash, "RESIDENCY_CAP", CAP)
    monkeypatch.setattr(jax_fch, "RESIDENCY_CAP", CAP)
    was = metrics.OBS.on
    events.EVENTS.clear()
    device.reset_engine_notes()
    metrics.enable()
    try:
        yield
    finally:
        metrics.OBS.on = was
        events.EVENTS.clear()
        device.reset_engine_notes()


def _engines() -> list[str]:
    return [e["fields"]["engine"]
            for e in events.EVENTS.events("device.engine.select")
            if e["fields"]["component"] == "cdc.hash"]


def test_the_reference_blob_is_cut_into_many_chunks(reference):
    want, single = reference
    assert len(BLOB) >= 3 * CAP and want.nchunks > 300
    assert single.cuts == want.cuts and single.root == want.root
    assert np.array_equal(single.digests, want.digests)


@pytest.mark.parametrize("route", ROUTES)
def test_slabbed_content_address_matches_the_jax_package(route, capped,
                                                         reference):
    want, single = reference
    jax_capped = jax_content.content_address(BLOB)
    got = content.content_address(BLOB, route=route, device="cpu")
    assert _engines() == ["two-pass-cpu"]
    for other in (want, jax_capped):
        assert got.length == other.length and got.cuts == other.cuts
        assert np.array_equal(got.digests, other.digests)
        assert got.root == other.root
    assert got == single and np.array_equal(got.digests, single.digests)
    offs, lens = got.extents()
    assert [got.digests[i].tobytes() for i in range(got.nchunks)] == [
        hashlib.blake2b(BLOB[o:o + n].tobytes(), digest_size=32).digest()
        for o, n in zip(offs.tolist(), lens.tolist())]
    assert got.root == merkle.root_host(got.digests)


@pytest.mark.parametrize("route", ["fused1p", "2p"])
def test_slabbed_content_digests_match_the_jax_package(route, capped,
                                                       reference):
    want, _ = reference
    cuts, digests = content.content_digests(BLOB, route=route, device="cpu")
    jcuts, jdigests = jax_content.content_digests(BLOB, route=route)
    assert _engines() == ["two-pass-cpu"]
    assert cuts == jcuts == want.cuts
    assert np.array_equal(digests, jdigests)
    assert np.array_equal(digests, want.digests)
