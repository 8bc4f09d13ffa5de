"""The port's Merkle diff, incremental updates and proofs against the JAX
package and the hashlib references.

Leaf digests are made with numpy from a seed.  The JAX side runs its
jitted ``diff_root_guided``/``update_leaves`` on the CPU (no Pallas
kernel under them there).  Every comparison is byte-exact.  Kernel B2
runs only on a CUDA card (``cuda`` marker).
"""

import hashlib

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import merkle as jax_merkle
from dat_replication_protocol_tpu_torch.ops import merkle
from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
    merkle_level_kernel,
)
from dat_replication_protocol_tpu_torch.weights import (
    levels_from_numpy,
    levels_to_numpy,
)


def _leaves(n, seed):
    rng = np.random.default_rng(seed)
    return [hashlib.blake2b(rng.bytes(int(rng.integers(0, 200))),
                            digest_size=32).digest() for _ in range(n)]


def _snapshots(n, seed, changed):
    """A and B: B has ``changed`` leaves (seeded positions) replaced."""
    a = _leaves(n, seed)
    b = list(a)
    rng = np.random.default_rng(seed + 1000)
    for i, d in zip(rng.choice(n, changed, replace=False),
                    _leaves(changed, seed + 2000)):
        b[i] = d
    return a, b


def _both(a, b):
    return (*merkle.digests_to_device(a, device="cpu"),
            *merkle.digests_to_device(b, device="cpu"))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("n,changed", [(1, 1), (2, 1), (4, 0), (32, 5),
                                       (256, 17)])
def test_diff_root_guided_matches_jax_and_host_diff(n, changed):
    a, b = _snapshots(n, seed=n, changed=changed)
    mask, (ah, al), (bh, bl) = merkle.diff_root_guided(*_both(a, b))
    jmask, (jah, jal), (jbh, jbl) = jax_merkle.diff_root_guided(
        *jax_merkle.digests_to_device(a), *jax_merkle.digests_to_device(b))
    assert mask.dtype == torch.bool
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    for got, want in ((ah, jah), (al, jal), (bh, jbh), (bl, jbl)):
        assert np.array_equal(_u32(got), np.asarray(want))
    assert np.nonzero(mask.numpy())[0].tolist() == jax_merkle.host_diff(a, b)
    assert merkle.digests_from_device(ah, al)[0] == merkle.root_host(a)
    assert merkle.digests_from_device(bh, bl)[0] == merkle.root_host(b)


@pytest.mark.parametrize("n,changed", [(1, 1), (2, 2), (64, 40)])
def test_packed_diff_matches_jax(n, changed):
    a, b = _snapshots(n, seed=100 + n, changed=changed)
    bits, ra, rb = merkle.diff_root_guided_packed(*_both(a, b))
    jbits, jra, jrb = jax_merkle.diff_root_guided_packed(
        *jax_merkle.digests_to_device(a), *jax_merkle.digests_to_device(b))
    assert bits.dtype == torch.int32 and bits.shape == ((n + 31) // 32,)
    assert np.array_equal(_u32(bits), np.asarray(jbits))
    assert np.array_equal(_u32(ra[0]), np.asarray(jra[0]))
    assert np.array_equal(_u32(rb[1]), np.asarray(jrb[1]))
    got = np.nonzero(merkle.unpack_mask(bits, n))[0].tolist()
    assert got == jax_merkle.host_diff(a, b)


@pytest.mark.parametrize("n", [1, 2, 8, 128, 256])
def test_diff_matches_host_diff_at_every_density(n):
    for changed in sorted({0, 1, n // 2, n}):
        a, b = _snapshots(n, seed=7 * n + changed, changed=changed)
        mask, _, _ = merkle.diff_root_guided(*_both(a, b))
        assert np.nonzero(mask.numpy())[0].tolist() == merkle.host_diff(a, b)


def test_pack_mask_keeps_bit_31_and_the_lsb_first_order():
    rng = np.random.default_rng(3)
    dense = rng.integers(0, 2, 100).astype(bool)
    dense[31] = dense[63] = True
    words = merkle.pack_mask(torch.from_numpy(dense))
    want = np.packbits(np.pad(dense, (0, 28)), bitorder="little").view(
        "<u4")
    assert np.array_equal(_u32(words), want)
    assert np.array_equal(merkle.unpack_mask(words, 100), dense)
    full = merkle.pack_mask(torch.ones(32, dtype=torch.bool))
    assert _u32(full).tolist() == [0xFFFFFFFF]


@pytest.mark.parametrize("n", [1, 2, 16, 256])
def test_diff_snapshots_matches_jax(n):
    a, b = _snapshots(n, seed=50 + n, changed=max(1, n // 7))
    got = merkle.diff_snapshots(*_both(a, b))
    want = jax_merkle.diff_snapshots(
        *(np.asarray(x) for x in (*jax_merkle.digests_to_device(a),
                                  *jax_merkle.digests_to_device(b))))
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 5, 8, 100])
def test_diff_leaves_pads_like_the_reference(n):
    a, b = _snapshots(n, seed=200 + n, changed=max(1, n // 3))
    got = merkle.diff_leaves(a, b, device="cpu")
    p = 1 << max(0, n - 1).bit_length()
    zero = [b"\0" * 32] * (p - n)
    assert got == merkle.host_diff(a + zero, b + zero)
    if n == 5:
        assert got == jax_merkle.diff_leaves(a, b)


@pytest.mark.parametrize("call", [
    merkle.diff_root_guided, merkle.diff_root_guided_packed,
    merkle.diff_snapshots], ids=["mask", "packed", "snapshots"])
@pytest.mark.parametrize("na,nb,match", [
    (3, 3, "power of two"), (0, 0, "power of two"), (4, 8, "differ|equal"),
], ids=["width-3", "empty", "unequal"])
def test_diffs_reject_bad_widths(call, na, nb, match):
    a = merkle.digests_to_device(_leaves(na, 1), device="cpu") if na else (
        torch.zeros((0, 4), dtype=torch.int32),) * 2
    b = merkle.digests_to_device(_leaves(nb, 2), device="cpu") if nb else (
        torch.zeros((0, 4), dtype=torch.int32),) * 2
    with pytest.raises(ValueError, match=match):
        call(*a, *b)


def test_diff_leaves_rejects_unequal_lists_and_takes_empty_ones():
    with pytest.raises(ValueError, match="equal leaf counts"):
        merkle.diff_leaves(_leaves(2, 1), _leaves(3, 1), device="cpu")
    assert merkle.diff_leaves([], [], device="cpu") == []


def _tree(leaves):
    return merkle.build_tree(*merkle.digests_to_device(leaves, device="cpu"))


@pytest.mark.parametrize("n,k", [(2, 1), (16, 3), (64, 9), (256, 40)])
def test_update_leaves_matches_a_rebuild_and_keeps_its_input(n, k):
    rng = np.random.default_rng(n + k)
    leaves = _leaves(n, seed=300 + n)
    levels_hh, levels_hl = _tree(leaves)
    kept = [t.clone() for t in levels_hh + levels_hl]
    pos = rng.choice(n, k, replace=False)
    new = _leaves(k, seed=400 + n)
    nh, nl = merkle.digests_to_device(new, device="cpu")
    up_hh, up_hl = merkle.update_leaves(levels_hh, levels_hl, pos, nh, nl)
    updated = list(leaves)
    for i, d in zip(pos, new):
        updated[i] = d
    want_hh, want_hl = _tree(updated)
    assert len(up_hh) == len(want_hh)
    for got, want in zip(up_hh + up_hl, want_hh + want_hl):
        assert torch.equal(got, want)
    for now, before in zip(levels_hh + levels_hl, kept):
        assert torch.equal(now, before)


def test_update_leaves_matches_jax():
    leaves = _leaves(64, seed=9)
    idx = np.array([0, 5, 6, 33, 63], dtype=np.int32)
    new = _leaves(5, seed=10)
    jh, jl = jax_merkle.build_tree(*jax_merkle.digests_to_device(leaves))
    jax_up = jax_merkle.update_leaves(jh, jl, idx,
                                      *jax_merkle.digests_to_device(new))
    th, tl = levels_from_numpy([np.asarray(x) for x in jh],
                               [np.asarray(x) for x in jl], device="cpu")
    up = merkle.update_leaves(th, tl, idx,
                              *merkle.digests_to_device(new, device="cpu"))
    got_h, got_l = levels_to_numpy(*up)
    for got, want in zip(got_h + got_l, jax_up[0] + jax_up[1]):
        assert np.array_equal(got, np.asarray(want))


def test_update_leaves_edges():
    leaves = _leaves(8, seed=11)
    levels = _tree(leaves)
    empty = torch.zeros((0, 4), dtype=torch.int32)
    same = merkle.update_leaves(*levels, np.zeros(0, np.int64), empty, empty)
    for got, want in zip(same[0] + same[1], levels[0] + levels[1]):
        assert torch.equal(got, want)
    # a duplicated position with one value: parents recomputed alike
    nh, nl = merkle.digests_to_device(_leaves(1, 12) * 2, device="cpu")
    dup = merkle.update_leaves(*levels, [3, 3], nh, nl)
    want = _tree(leaves[:3] + _leaves(1, 12) + leaves[4:])
    for got, w in zip(dup[0] + dup[1], want[0] + want[1]):
        assert torch.equal(got, w)
    for bad in ([8], [-1]):
        with pytest.raises(IndexError, match="leaf positions"):
            merkle.update_leaves(*levels, bad, nh[:1], nl[:1])


@pytest.mark.parametrize("n", [1, 2, 16, 256])
def test_prove_matches_jax_and_verifies(n):
    leaves = _leaves(n, seed=500 + n)
    jh, jl = jax_merkle.build_tree(*jax_merkle.digests_to_device(leaves))
    levels_hh, levels_hl = _tree(leaves)
    root = merkle.root_host(leaves)
    for i in sorted({0, n // 3, n - 1}):
        path = merkle.prove(levels_hh, levels_hl, i)
        assert path == jax_merkle.prove(jh, jl, i)
        assert len(path) == (n - 1).bit_length()
        assert merkle.verify_proof(root, leaves[i], i, path, n)
        assert jax_merkle.verify_proof(root, leaves[i], i, path, n)
    with pytest.raises(IndexError, match="out of range"):
        merkle.prove(levels_hh, levels_hl, n)


def test_verify_proof_rejects_tampering():
    n = 64
    leaves = _leaves(n, seed=77)
    levels = _tree(leaves)
    root = merkle.root_host(leaves)
    path = merkle.prove(*levels, 21)
    assert merkle.verify_proof(root, leaves[21], 21, path, n)
    tampered = list(path)
    tampered[2] = bytes([tampered[2][0] ^ 0x80]) + tampered[2][1:]
    cases = [
        (root, leaves[21], 21, tampered, n),      # a flipped byte
        (root, leaves[21], 21, path[:-1], n),      # a short path
        (root, leaves[21], 20, path, n),           # a wrong index
        (root, leaves[21], 21 + n, path, n),       # out of range
        (root, leaves[21], -1, path, n),
        (root, leaves[21], 21, path, 0),
        (root, leaves[20], 21, path, n),           # a wrong leaf
    ]
    for args in cases:
        assert not merkle.verify_proof(*args)
        assert not jax_merkle.verify_proof(*args)


def test_cpu_diff_launches_nothing():
    a, b = _snapshots(16, seed=5, changed=2)
    before = merkle_level_kernel.launches
    merkle.diff_root_guided_packed(*_both(a, b))
    merkle.update_leaves(*_tree(a), [1],
                         *merkle.digests_to_device(b[:1], device="cpu"))
    assert merkle_level_kernel.launches == before


@pytest.mark.cuda
def test_diff_update_and_proofs_on_card(cuda_device):
    a, b = _snapshots(1024, seed=60, changed=37)
    dev = [t.to(cuda_device) for t in _both(a, b)]
    before = merkle_level_kernel.launches
    bits, ra, rb = merkle.diff_root_guided_packed(*dev)
    assert merkle_level_kernel.launches == before + 10
    got = np.nonzero(merkle.unpack_mask(bits, 1024))[0].tolist()
    assert got == merkle.host_diff(a, b)
    assert np.array_equal(merkle.diff_snapshots(*dev), np.array(got))
    assert merkle.diff_leaves(a, b, device=cuda_device) == got
    assert merkle.digests_from_device(*ra)[0] == merkle.root_host(a)
    levels = merkle.build_tree(dev[0], dev[1])
    nh, nl = dev[2][:3], dev[3][:3]
    before = merkle_level_kernel.launches
    up = merkle.update_leaves(*levels, [4, 9, 1000], nh, nl)
    assert merkle_level_kernel.launches == before + 10
    cpu_up = merkle.update_leaves(*_tree(a), [4, 9, 1000], nh.cpu(),
                                  nl.cpu())
    for g, w in zip(up[0] + up[1], cpu_up[0] + cpu_up[1]):
        assert torch.equal(g.cpu(), w)
    path = merkle.prove(*levels, 77)
    assert merkle.verify_proof(merkle.root_host(a), a[77], 77, path, 1024)
