"""The port's tree-sync descent against the JAX package.

Leaf digests are made with numpy from a seed.  The JAX side runs its
``TreeSyncSession``/``sync`` over trees from its own ``build_tree`` (the
port's levels carried across by ``weights.levels_to_numpy`` where the
JAX build would only recompile at another width; ``test_torch_merkle``
holds the two builds equal).  Indices, messages and the transcript are
compared byte for byte.  The card path runs only on a CUDA card
(``cuda`` marker).
"""

import hashlib

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.ops import merkle as jax_merkle
from dat_replication_protocol_tpu.runtime.tree_sync import (
    TreeSyncSession as JaxSession,
)
from dat_replication_protocol_tpu.runtime.tree_sync import sync as jax_sync
from dat_replication_protocol_tpu_torch.ops import merkle
from dat_replication_protocol_tpu_torch.ops import reconcile as rec
from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
    merkle_level_kernel,
)
from dat_replication_protocol_tpu_torch.runtime.tree_sync import (
    TreeSyncSession,
    sync,
)
from dat_replication_protocol_tpu_torch.weights import levels_to_numpy


def _leaves(n, seed):
    rng = np.random.default_rng(seed)
    return [hashlib.blake2b(rng.bytes(24), digest_size=32).digest()
            for _ in range(n)]


def _changed(a, positions, seed):
    b = list(a)
    for i, d in zip(positions, _leaves(len(positions), seed)):
        b[i] = d
    return b


def _tree(leaves, device="cpu"):
    return merkle.build_tree(*merkle.digests_to_device(leaves, device=device))


def _jax_session(leaves, jax_build=False):
    if jax_build:
        return JaxSession(*jax_merkle.build_tree(
            *jax_merkle.digests_to_device(leaves)))
    return JaxSession(*levels_to_numpy(*_tree(leaves)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("n,positions", [
    (1, [0]), (2, [1]), (64, [3]), (64, [0, 17, 18, 63]),
    (256, list(range(0, 256, 9))), (256, list(range(256)))])
def test_sync_matches_jax(n, positions):
    a = _leaves(n, seed=n)
    b = _changed(a, positions, seed=n + 1)
    ours, theirs = [], []
    got = sync(TreeSyncSession(*_tree(a)), TreeSyncSession(*_tree(b)), ours)
    want = jax_sync(_jax_session(a, jax_build=n == 64),
                    _jax_session(b, jax_build=n == 64), theirs)
    assert got == want == sorted(positions)
    assert ours == theirs
    assert got == merkle.host_diff(a, b)


def test_equal_trees_cost_one_exchange():
    a = _leaves(32, seed=2)
    transcript = []
    assert sync(TreeSyncSession(*_tree(a)), TreeSyncSession(*_tree(a)),
                transcript) == []
    assert transcript == [("a->b", 32), ("b->a", 1)]


def test_messages_match_jax_byte_for_byte():
    a = _leaves(64, seed=3)
    b = _changed(a, [5, 40], seed=4)
    ours_a, ours_b = TreeSyncSession(*_tree(a)), TreeSyncSession(*_tree(b))
    jax_a, jax_b = _jax_session(a), _jax_session(b)
    assert ours_a.root() == jax_a.root() == merkle.root_host(a)
    frontier = [0, 1, 3]
    req = ours_a.request(3, frontier)
    assert req == jax_a.request(3, frontier) and len(req) == 6 * 32
    reply = ours_b.respond(3, frontier, req)
    assert reply == jax_b.respond(3, frontier, req)
    assert ours_a.next_frontier(frontier, reply) == jax_a.next_frontier(
        frontier, reply)
    assert ours_a.request(0, []) == b""


def test_length_checks_match_the_reference():
    a = TreeSyncSession(*_tree(_leaves(16, seed=5)))
    with pytest.raises(ValueError, match="round message holds 63 bytes"):
        a.respond(2, [0], b"\0" * 63)
    with pytest.raises(ValueError, match="differ-bitmap holds 2 bytes"):
        a.next_frontier([0, 1], b"\0\0")
    with pytest.raises(ValueError, match="equal"):
        sync(a, TreeSyncSession(*_tree(_leaves(32, seed=6))))


def test_sketch_cells_found_remotely_equal_the_local_diff():
    keys = [b"k%04d" % i for i in range(400)]
    recs = [b"record:" + k for k in keys]
    b_keys = keys[:17] + [b"inserted-a"] + keys[17:333] + [b"inserted-b"] \
        + keys[333:]
    b_recs = [b"record:" + k for k in b_keys]
    sa = rec.LogSummary(recs, keys, 10, device="cpu")
    sb = rec.LogSummary(b_recs, b_keys, 10, device="cpu")
    local = rec.diff_sketches(sa.table, sb.table).tolist()
    transcript = []
    remote = sync(TreeSyncSession(*merkle.build_tree(*rec.table_leaves(
        sa.table))), TreeSyncSession(*merkle.build_tree(*rec.table_leaves(
            sb.table))), transcript)
    assert remote == local and len(local) >= 2
    assert sum(nb for _, nb in transcript) < (1 << 10) * 32 // 4


def test_cpu_sync_launches_nothing():
    before = merkle_level_kernel.launches
    a = _leaves(8, seed=7)
    sync(TreeSyncSession(*_tree(a)),
         TreeSyncSession(*_tree(_changed(a, [2], seed=8))))
    assert merkle_level_kernel.launches == before


@pytest.mark.cuda
def test_sync_on_card_matches_cpu(cuda_device):
    a = _leaves(4096, seed=9)
    b = _changed(a, [1, 700, 4095], seed=10)
    ours, cpu = [], []
    got = sync(TreeSyncSession(*_tree(a, cuda_device)),
               TreeSyncSession(*_tree(b, cuda_device)), ours)
    want = sync(TreeSyncSession(*_tree(a)), TreeSyncSession(*_tree(b)), cpu)
    assert got == want == [1, 700, 4095] and ours == cpu
