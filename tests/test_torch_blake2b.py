"""The port's batched BLAKE2b against the JAX package and hashlib.

Inputs are made with numpy from a seed and handed to both sides: the
port's plain PyTorch version on the CPU, and the JAX package's Pallas
kernel in interpret mode.  Digests are hashes, so every comparison is
exact.  Kernel B1 itself runs only on a CUDA card (``cuda`` marker).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import blake2b as jax_b2b
from dat_replication_protocol_tpu.ops.blake2b_pallas import (
    blake2b_packed_pallas,
)
from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
    LANES,
    QUAD_MAX_ITEMS,
    blake2b_packed_kernel,
    lanes_per_item,
    launch,
)

EDGE_LENGTHS = (0, 1, 127, 128, 129, 255, 256, 1000)


def _payloads(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def _hashlib(payloads, digest_size=32):
    return [hashlib.blake2b(p, digest_size=digest_size).digest()
            for p in payloads]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def test_plain_matches_pallas_interpret_and_hashlib():
    payloads = _payloads(EDGE_LENGTHS)
    mh, ml, lengths = jax_b2b.pack_payloads(payloads, nblocks=8)
    jh, jl = blake2b_packed_pallas(jnp.asarray(mh), jnp.asarray(ml),
                                   jnp.asarray(lengths), interpret=True)
    th, tl = b2b.blake2b_packed(*b2b.pack_payloads(payloads, nblocks=8))
    assert np.array_equal(th.numpy().view(np.uint32), np.asarray(jh))
    assert np.array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    assert b2b.digests_to_bytes(th, tl) == _hashlib(payloads)


def test_plain_matches_hashlib_at_1024_blocks():
    payloads = _payloads((131072, 3, 0))
    hh, hl = b2b.blake2b_packed(*b2b.pack_payloads(payloads))
    assert b2b.digests_to_bytes(hh, hl) == _hashlib(payloads)


@pytest.mark.parametrize("digest_size", [1, 20, 32, 64])
def test_plain_digest_sizes_match_hashlib(digest_size):
    payloads = _payloads((0, 50, 300))
    hh, hl = b2b.blake2b_packed(*b2b.pack_payloads(payloads),
                                digest_size=digest_size)
    assert (b2b.digests_to_bytes(hh, hl, digest_size)
            == _hashlib(payloads, digest_size))


def test_pack_payloads_matches_jax_layout():
    payloads = _payloads(EDGE_LENGTHS, seed=3)
    jh, jl, jlen = jax_b2b.pack_payloads(payloads, nblocks=8)
    th, tl, tlen = b2b.pack_payloads(payloads, nblocks=8)
    assert np.array_equal(th.numpy().view(np.uint32), jh)
    assert np.array_equal(tl.numpy().view(np.uint32), jl)
    assert np.array_equal(tlen.numpy().view(np.uint32), jlen)
    with pytest.raises(ValueError):
        b2b.pack_payloads(payloads, nblocks=2)


def test_initial_state_matches_jax():
    jh, jl = jax_b2b.initial_state(3, 32)
    th, tl = b2b.initial_state(3, 32, device="cpu")
    assert np.array_equal(th.numpy().view(np.uint32), np.asarray(jh))
    assert np.array_equal(tl.numpy().view(np.uint32), np.asarray(jl))


def test_compress_one_block_matches_hashlib():
    payloads = _payloads((5, 128))
    mh, ml, lengths = b2b.pack_payloads(payloads)
    hh, hl = b2b.initial_state(2, device="cpu")
    hh, hl = b2b.compress(hh, hl, mh[:, 0], ml[:, 0], lengths,
                          torch.ones(2, dtype=torch.bool))
    assert b2b.digests_to_bytes(hh, hl) == _hashlib(payloads)


@pytest.mark.parametrize("n,want", [(0, 1), (1, 1), (2, 2), (3, 4), (5, 8),
                                    (8, 8), (1000, 1024), (8192, 8192)])
def test_bucket_nblocks_rounds_up_to_power_of_two(n, want):
    assert b2b._bucket_nblocks(n) == want
    assert jax_b2b._bucket_nblocks(n) == want


def test_batch_orders_digests_across_buckets():
    lengths = (1000, 0, 131072 // 64, 129, 1, 5000, 128, 256, 255, 127)
    payloads = _payloads(lengths, seed=11)
    buckets = {b2b._bucket_nblocks(b2b._need_blocks(n)) for n in lengths}
    assert len(buckets) >= 4
    assert b2b.blake2b_batch(payloads, device="cpu") == _hashlib(payloads)


def test_batch_begin_on_cpu_has_a_noop_readback():
    payloads = _payloads((3, 300))
    collect = b2b.blake2b_batch_begin(payloads, device="cpu")
    collect.start_d2h()
    assert collect() == _hashlib(payloads)
    assert b2b.blake2b_batch([], device="cpu") == []


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    payloads = _payloads((0, 200))
    before = blake2b_packed_kernel.launches
    hh, hl = blake2b_packed_kernel(*b2b.pack_payloads(payloads))
    assert blake2b_packed_kernel.launches == before
    assert b2b.digests_to_bytes(hh, hl) == _hashlib(payloads)


# (bucket batch, lanes): the digest session's blob bucket (31-32 blobs),
# its change bucket, content addressing's largest chunk bucket, the last
# batch that leaves one warp a scheduler, and entry()'s 2^20 items
@pytest.mark.parametrize("batch,want", [
    (1, 4), (31, 4), (32, 4), (33, 4), (1024, 4), (2048, 4),
    (QUAD_MAX_ITEMS, 4), (QUAD_MAX_ITEMS + 1, 1), (2 * QUAD_MAX_ITEMS, 1),
    (1 << 20, 1)])
def test_lanes_per_item_rule(batch, want):
    assert lanes_per_item(batch) == want
    assert lanes_per_item(batch) in LANES


def test_launch_refuses_cpu_tensors_and_counts_nothing():
    mh, ml, lengths = b2b.pack_payloads(_payloads((3, 300)))
    before = dict(blake2b_packed_kernel.launches_by_lanes)
    by_blocks = dict(blake2b_packed_kernel.launches_by_blocks)
    for lanes in LANES:
        with pytest.raises(ValueError, match="unsupported device"):
            launch(mh, ml, lengths, 32, lanes)
    assert blake2b_packed_kernel.launches_by_lanes == before
    assert blake2b_packed_kernel.launches_by_blocks == by_blocks


def test_batch_rejects_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        b2b.blake2b_batch([b"x"])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    payloads = _payloads(EDGE_LENGTHS + (131072,))
    mh, ml, lengths = (t.to(cuda_device)
                       for t in b2b.pack_payloads(payloads))
    before = blake2b_packed_kernel.launches
    got = blake2b_packed_kernel(mh, ml, lengths)
    want = b2b.blake2b_packed(mh, ml, lengths)
    torch.cuda.synchronize()
    assert blake2b_packed_kernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert b2b.digests_to_bytes(got[0].cpu(), got[1].cpu()) == _hashlib(
        payloads)
    assert b2b.blake2b_batch(payloads, device=cuda_device) == _hashlib(
        payloads)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda_device):
    mh, ml, lengths = (t.to(cuda_device)
                       for t in b2b.pack_payloads([b"abc"]))
    with pytest.raises(TypeError):
        blake2b_packed_kernel(mh.to(torch.int64), ml, lengths)
    with pytest.raises(ValueError):
        blake2b_packed_kernel(mh, ml[:, :, :8].contiguous(), lengths)
    with pytest.raises(ValueError):
        blake2b_packed_kernel(mh, ml, lengths, digest_size=65)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n_items", [1, 31, 32, 33])
def test_each_variant_matches_plain_and_hashlib_on_card(cuda_device, lanes,
                                                        n_items):
    lengths = (EDGE_LENGTHS * 5)[:n_items]
    payloads = _payloads(lengths, seed=n_items)
    mh, ml, lens = (t.to(cuda_device) for t in b2b.pack_payloads(payloads))
    before = blake2b_packed_kernel.launches_by_lanes[lanes]
    nblocks = mh.shape[1]
    by_blocks = blake2b_packed_kernel.launches_by_blocks.get(nblocks, 0)
    got = launch(mh, ml, lens, 32, lanes)
    want = b2b.blake2b_packed(mh, ml, lens)
    torch.cuda.synchronize()
    assert blake2b_packed_kernel.launches_by_lanes[lanes] == before + 1
    assert blake2b_packed_kernel.launches_by_blocks[nblocks] == by_blocks + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert b2b.digests_to_bytes(got[0].cpu(), got[1].cpu()) == _hashlib(
        payloads)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANES)
def test_each_variant_matches_hashlib_on_long_items_on_card(cuda_device,
                                                            lanes):
    payloads = _payloads((8192 * 128, 8192 * 128 - 77, 0, 129, 5))
    got = launch(*(t.to(cuda_device) for t in b2b.pack_payloads(payloads)),
                 20, lanes)
    assert b2b.digests_to_bytes(got[0].cpu(), got[1].cpu(), 20) == _hashlib(
        payloads, 20)


@pytest.mark.cuda
def test_launch_rejects_other_lane_counts_on_card(cuda_device):
    mh, ml, lengths = (t.to(cuda_device)
                       for t in b2b.pack_payloads([b"abc"]))
    with pytest.raises(ValueError, match="lanes"):
        launch(mh, ml, lengths, 32, 2)
