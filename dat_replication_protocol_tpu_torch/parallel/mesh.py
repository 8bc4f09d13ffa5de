"""Multi-device scale-out on ``torch.distributed``: the sharded digest,
Merkle, diff and sketch steps.

The counterpart of ``dat_replication_protocol_tpu/parallel/mesh.py``.  The
reference runs one controller over a ``jax.sharding.Mesh`` and
``shard_map``; the port runs one process per device (SPMD) in a process
group that the caller has initialized (``nccl`` on cards, ``gloo`` on CPU
tensors).  The mapping:

* every step takes the reference's *global* arrays, present on every
  rank (on the host or on this rank's device), and each rank takes its
  own contiguous slice of the batch (or leaf) axis with :func:`shard`:
  the counterpart of ``device_put(x, batch_sharding(mesh))``.  Outputs the
  reference shards are returned as this rank's slice; outputs it
  replicates are equal on every rank;
* per-rank work runs the single-device ops on this rank's device: kernel
  B1 (:mod:`..ops.blake2b_cuda`) and the Merkle fold on B2
  (:mod:`..ops.merkle`), with no communication;
* the collectives are ``all_gather`` of each rank's (1, 4) hi/lo subtree
  root (32 bytes a rank) and ``all_reduce`` of byte counts and of sketch
  tables, as the reference's ``all_gather``/``psum``.  The top tree over
  the gathered roots is folded on every rank;
* where one process composes the work (the hub on rank 0),
  :func:`broadcast_payloads` hands each payload list to the other ranks,
  which wait in :func:`receive_payloads`: the reference's single
  controller sees every array, a rank here only what it is sent.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops import merkle
from ..ops import reconcile
from ..ops.blake2b import (_bucket_nblocks, bucket_by_blocks,
                           digest_collector, stage_batch)
from ..ops.blake2b_cuda import blake2b_packed_kernel
from ..utils.device import resolve_device

DATA_AXIS = "data"
_MASK32 = 0xFFFFFFFF
# the backend a process group needs for tensors on each device type
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: the process group, its size, this process's rank
    in it and this rank's device."""

    group: object
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The data mesh over the initialized default process group, one
    device a rank.

    Power-of-two sizes only: the cross-rank Merkle merge builds a binary
    top tree over per-rank roots.  The mesh spans the whole group.
    ``device`` must suit the group's backend: ``nccl`` for CUDA, ``gloo``
    for the CPU.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    backend = str(dist.get_backend())
    if backend != _BACKENDS[dev.type]:
        raise ValueError(f"a {backend} group cannot hold {dev.type} tensors; "
                         f"use {_BACKENDS[dev.type]}")
    size = dist.get_world_size()
    if n_devices is None:
        n_devices = size
    if n_devices > size:
        raise ValueError(f"requested {n_devices} devices, have {size}")
    if n_devices & (n_devices - 1) or n_devices < 1:
        raise ValueError(f"device count {n_devices} is not a power of two")
    if n_devices != size:
        raise ValueError(f"a mesh spans its whole group: {n_devices} devices "
                         f"requested of a group of {size} ranks")
    return Mesh(dist.group.WORLD, size, dist.get_rank(), dev)


def shard(mesh: Mesh, x) -> torch.Tensor:
    """This rank's contiguous slice of the leading axis of a global array
    (a tensor or a numpy array), on the mesh's device."""
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading axis {x.shape[0]} is not divisible by the "
                         f"mesh size {mesh.size}")
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def _all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated in rank order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x, group=mesh.group)
    return torch.cat(out)


def _merge_roots(mesh: Mesh, *roots):
    """Gather each rank's (1, 4) hi/lo subtree roots and fold the top tree
    on every rank: one ``all_gather`` of 32 bytes a root a rank.  Returns
    one replicated ((1, 4), (1, 4)) pair per root."""
    words = _all_gather(mesh, torch.cat([w for r in roots for w in r])[None])
    out = []
    for j in range(len(roots)):
        out.append(merkle.root(words[:, 2 * j].contiguous(),
                               words[:, 2 * j + 1].contiguous()))
    return out


def _check_shard(mesh: Mesh, B: int, what: str) -> None:
    n = mesh.size
    per = B // n if n and B % n == 0 else None
    if per is None or per & (per - 1) or per == 0:
        raise ValueError(
            f"{what}: batch size {B} over {n} devices needs a power-of-two "
            f"per-chip shard (got {B}/{n}); pad the batch first "
            f"(:func:`pad_batch` does)"
        )


def pad_batch(mesh: Mesh, mh, ml, lengths):
    """Pad a packed global batch so every rank gets a power-of-two shard.

    Padding items are zero-length payloads; the policy is the
    reference's, the smallest ``n_devices * 2**k >= B``, so two replicas
    padded alike keep comparable roots.  Returns ``(mh, ml, lengths, B)``
    with B the original batch size.
    """
    n = mesh.size
    mh, ml, lengths = (torch.as_tensor(t) for t in (mh, ml, lengths))
    B = mh.shape[0]
    pad = n * _bucket_nblocks(-(-B // n)) - B
    if pad:
        mh = torch.nn.functional.pad(mh, (0, 0, 0, 0, 0, pad))
        ml = torch.nn.functional.pad(ml, (0, 0, 0, 0, 0, pad))
        lengths = torch.nn.functional.pad(lengths, (0, pad))
    return mh, ml, lengths, B


def digest_root_step(mesh: Mesh, mh, ml, lengths):
    """The sharded full step: a padded global batch in, digests and the
    global Merkle root out.

    ``mh``/``ml``: (B, nblocks, 16) message halves, ``lengths`` (B,), as
    :func:`..ops.blake2b.blake2b_packed` takes them, with B divisible by
    the mesh size into power-of-two shards.  Each rank hashes its shard
    on B1 and folds the leaves (each digest's first four word pairs) to a
    subtree root on B2; the roots are gathered and the top tree folded on
    every rank; the byte count is an ``all_reduce`` of the lengths' 16-bit
    half-sums.

    Returns ``(leaf_hh, leaf_hl, root_hh, root_hl, total_bytes)``: this
    rank's (B/n, 4) leaves, the replicated (1, 4) root and the exact
    total as a Python int.
    """
    _check_shard(mesh, mh.shape[0], "digest_root_step")
    mh, ml, lengths = (shard(mesh, t) for t in (mh, ml, lengths))
    hh, hl = blake2b_packed_kernel(mh, ml, lengths)
    leaf_hh, leaf_hl = hh[:, :4].contiguous(), hl[:, :4].contiguous()
    [(root_hh, root_hl)] = _merge_roots(mesh, merkle.root(leaf_hh, leaf_hl))
    n = lengths.to(torch.int64) & _MASK32
    halves = torch.stack([(n >> 16).sum(), (n & 0xFFFF).sum()])
    dist.all_reduce(halves, group=mesh.group)
    hi, lo = halves.tolist()
    return leaf_hh, leaf_hl, root_hh, root_hl, (hi << 16) + lo


def sharded_hash_begin(mesh: Mesh, payloads, digest_size: int = 32):
    """Hash a payload list over the mesh; returns ``collect()`` with
    ``collect.start_d2h``, the contract of
    :func:`..ops.blake2b.blake2b_batch_begin`.

    Every rank passes the same list.  Payloads are bucketed by power-of-two
    block count; each bucket is padded to ``n_devices * 2**k`` items, and
    each rank stages and hashes only its slice on B1.  The digests are then
    gathered, so ``collect()`` returns every payload's digest in submit
    order on every rank, as the reference's single controller does.
    """
    n = mesh.size
    handles = []
    for nb, idxs in bucket_by_blocks(payloads).items():
        per = _bucket_nblocks(-(-len(idxs) // n))
        mine = idxs[mesh.rank * per:(mesh.rank + 1) * per]
        batch = [payloads[i] for i in mine] + [b""] * (per - len(mine))
        hh, hl = blake2b_packed_kernel(*stage_batch(batch, nb, mesh.device),
                                       digest_size)
        words = _all_gather(mesh, torch.cat([hh, hl], dim=1))
        handles.append((idxs, words[:len(idxs), :8], words[:len(idxs), 8:]))
    return digest_collector(len(payloads), handles, digest_size, mesh.device)


# the header a follower reads before each batch: [items, bytes]; a
# negative item count is the stop message
_STOP_ITEMS = -1


def broadcast_payloads(mesh: Mesh, payloads) -> None:
    """Rank 0's half of :func:`receive_payloads`: send one payload list
    to every other rank, as a ``[items, bytes]`` header, the lengths and
    one byte tensor of the payloads end to end (three broadcasts).
    :func:`sharded_hash_begin` needs the same list on every rank; a
    process that composes batches alone (the hub) sends each one before
    the call."""
    lengths = [len(p) for p in payloads]
    total = sum(lengths)
    head = torch.tensor([len(lengths), total], dtype=torch.int64,
                        device=mesh.device)
    dist.broadcast(head, 0, group=mesh.group)
    if not lengths:
        return
    dist.broadcast(torch.tensor(lengths, dtype=torch.int64,
                                device=mesh.device), 0, group=mesh.group)
    if total:
        data = torch.frombuffer(bytearray().join(payloads),
                                dtype=torch.uint8).to(mesh.device)
        dist.broadcast(data, 0, group=mesh.group)


def broadcast_stop(mesh: Mesh) -> None:
    """Rank 0: tell every :func:`receive_payloads` caller to stop."""
    head = torch.tensor([_STOP_ITEMS, 0], dtype=torch.int64,
                        device=mesh.device)
    dist.broadcast(head, 0, group=mesh.group)


def receive_payloads(mesh: Mesh):
    """A rank >= 1's half of :func:`broadcast_payloads`: the next payload
    list rank 0 sends, or ``None`` on :func:`broadcast_stop`."""
    head = torch.empty(2, dtype=torch.int64, device=mesh.device)
    dist.broadcast(head, 0, group=mesh.group)
    n, total = head.tolist()
    if n == _STOP_ITEMS:
        return None
    if n == 0:
        return []
    lengths = torch.empty(n, dtype=torch.int64, device=mesh.device)
    dist.broadcast(lengths, 0, group=mesh.group)
    data = b""
    if total:
        buf = torch.empty(total, dtype=torch.uint8, device=mesh.device)
        dist.broadcast(buf, 0, group=mesh.group)
        data = buf.cpu().numpy().tobytes()
    out, off = [], 0
    for length in lengths.tolist():
        out.append(data[off:off + length])
        off += length
    return out


def sharded_sketch(mesh: Mesh, rec_hh, rec_hl, slots, log2_slots: int):
    """The key-addressed reconciliation sketch built across the mesh.

    ``rec_hh``/``rec_hl``: (B, 4) global record digest halves and ``slots``
    (B,) cell indices, int32 tensors holding u32 bits.  The batch is
    zero-padded to a multiple of the mesh size (a zero digest adds
    nothing), each rank scatter-adds its slice into a local table of int64
    sums of the words' unsigned values
    (:func:`..ops.reconcile.sketch_sums`), and one ``all_reduce`` adds the
    tables.  Cells are wrapping u32 sums: the int64 sums are exact for
    fewer than 2**31 records, and their low 32 bits are kept, so the
    replicated (2**log2_slots, 8) int32 table equals the single-device
    build.
    """
    if not 0 < log2_slots <= 31:
        raise ValueError("log2_slots must be in [1, 31]")
    n = mesh.size
    rec_hh, rec_hl, slots = (torch.as_tensor(t) for t in (rec_hh, rec_hl,
                                                          slots))
    pad = -rec_hh.shape[0] % n
    if pad:
        rec_hh = torch.nn.functional.pad(rec_hh, (0, 0, 0, pad))
        rec_hl = torch.nn.functional.pad(rec_hl, (0, 0, 0, pad))
        slots = torch.nn.functional.pad(slots, (0, pad))
    sums = reconcile.sketch_sums(shard(mesh, rec_hh), shard(mesh, rec_hl),
                                 shard(mesh, slots), 1 << log2_slots)
    dist.all_reduce(sums, group=mesh.group)
    return sums.to(torch.int32)


def sharded_diff(mesh: Mesh, a_hh, a_hl, b_hh, b_hl):
    """Tree-guided diff of two snapshots with leaves sharded over ranks.

    Each rank diffs its slice of both global leaf arrays
    (:func:`..ops.merkle.diff_root_guided`, no communication: a differing
    leaf is decidable locally); both snapshots' subtree roots are merged
    in one gather.  Returns ``(mask, a_root, b_root)``: this rank's (N/n,)
    bool mask and each replicated root a ((1, 4), (1, 4)) hi/lo pair.
    """
    _check_shard(mesh, a_hh.shape[0], "sharded_diff")
    mask, root_a, root_b = merkle.diff_root_guided(
        *(shard(mesh, t) for t in (a_hh, a_hl, b_hh, b_hl)))
    root_a, root_b = _merge_roots(mesh, root_a, root_b)
    return mask, root_a, root_b

