"""The port's Merkle tree against the JAX package and hashlib.

Leaf digests are made with numpy from a seed.  The JAX side runs its
Pallas level kernel in interpret mode and its ``build_tree``; trees cross
between the two through ``weights.levels_from_numpy``/``levels_to_numpy``.
Kernel B2 itself runs only on a CUDA card (``cuda`` marker).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import merkle as jax_merkle
from dat_replication_protocol_tpu.ops.merkle_pallas import merkle_level_pallas
from dat_replication_protocol_tpu_torch.ops import merkle
from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
    merkle_level_kernel,
)
from dat_replication_protocol_tpu_torch.weights import (
    levels_from_numpy,
    levels_to_numpy,
)


def _leaves(n, seed=5):
    rng = np.random.default_rng(seed)
    return [hashlib.blake2b(rng.bytes(int(rng.integers(0, 300))),
                            digest_size=32).digest() for _ in range(n)]


def _jax_halves(leaves):
    hh, hl = jax_merkle.digests_to_device(leaves)
    return np.asarray(hh), np.asarray(hl)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def test_level_matches_pallas_interpret():
    hh, hl = _jax_halves(_leaves(64))
    jh, jl = merkle_level_pallas(jnp.asarray(hh), jnp.asarray(hl),
                                 interpret=True)
    (th,), (tl,) = levels_from_numpy([hh], [hl], device="cpu")
    ph, pl = merkle.merkle_level(th, tl)
    (gh,), (gl,) = levels_to_numpy([ph], [pl])
    assert np.array_equal(gh, np.asarray(jh))
    assert np.array_equal(gl, np.asarray(jl))


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_build_tree_levels_match_host_tree(n):
    leaves = _leaves(n, seed=n)
    hh, hl = merkle.digests_to_device(leaves, device="cpu")
    levels_hh, levels_hl = merkle.build_tree(hh, hl)
    want = merkle.host_tree(leaves)
    assert len(levels_hh) == len(want)
    for th, tl, level in zip(levels_hh, levels_hl, want):
        assert merkle.digests_from_device(th, tl) == level
    assert merkle.digests_from_device(*merkle.root(hh, hl))[0] == want[-1][0]


def test_build_tree_matches_jax_build_tree():
    leaves = _leaves(8, seed=21)
    jh, jl = jax_merkle.build_tree(*jax_merkle.digests_to_device(leaves))
    jax_levels = ([np.asarray(x) for x in jh], [np.asarray(x) for x in jl])
    lh, ll = levels_from_numpy(*jax_levels, device="cpu")
    th, tl = merkle.build_tree(lh[0], ll[0])
    got_h, got_l = levels_to_numpy(th, tl)
    for a, b in zip(got_h + got_l, jax_levels[0] + jax_levels[1]):
        assert np.array_equal(a, b)


def test_levels_round_trip_bit_for_bit():
    rng = np.random.default_rng(2)
    levels = [rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64)
              .astype(np.uint32) for n in (4, 2, 1)]
    th, tl = levels_from_numpy(levels, levels[::-1], device="cpu")
    assert all(t.dtype == torch.int32 for t in th + tl)
    back_h, back_l = levels_to_numpy(th, tl)
    for a, b in zip(back_h + back_l, levels + levels[::-1]):
        assert a.dtype == np.uint32 and np.array_equal(a, b)


def test_digest_halves_match_jax_layout():
    leaves = _leaves(16, seed=8)
    jh, jl = _jax_halves(leaves)
    th, tl = merkle.digests_to_device(leaves, device="cpu")
    assert np.array_equal(th.numpy().view(np.uint32), jh)
    assert np.array_equal(tl.numpy().view(np.uint32), jl)
    assert merkle.digests_from_device(th, tl) == leaves
    assert merkle.digest_matrix(th, tl).tobytes() == b"".join(leaves)


@pytest.mark.parametrize("n", [0, 1, 3, 5, 16])
def test_root_host_pads_like_jax(n):
    leaves = _leaves(n, seed=30 + n)
    matrix = np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(-1, 32)
    assert merkle.root_host(leaves) == jax_merkle.root_host(matrix)
    assert merkle.root_host(matrix) == jax_merkle.root_host(matrix)


def test_build_tree_rejects_non_power_of_two():
    hh, hl = merkle.digests_to_device(_leaves(3), device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        merkle.build_tree(hh, hl)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    hh, hl = merkle.digests_to_device(_leaves(4), device="cpu")
    before = merkle_level_kernel.launches
    ph, pl = merkle_level_kernel(hh, hl)
    assert merkle_level_kernel.launches == before
    assert torch.equal(ph, merkle.merkle_level(hh, hl)[0])
    assert torch.equal(pl, merkle.merkle_level(hh, hl)[1])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    leaves = _leaves(1024, seed=40)
    hh, hl = merkle.digests_to_device(leaves, device=cuda_device)
    before = merkle_level_kernel.launches
    levels_hh, levels_hl = merkle.build_tree(hh, hl)
    torch.cuda.synchronize()
    assert merkle_level_kernel.launches == before + 10
    got = merkle.digests_from_device(levels_hh[-1], levels_hl[-1])[0]
    assert got == merkle.root_host(leaves)
    ph, pl = merkle_level_kernel(hh, hl)
    qh, ql = merkle.merkle_level(hh, hl)
    assert torch.equal(ph, qh) and torch.equal(pl, ql)
