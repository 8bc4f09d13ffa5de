"""The port's mesh on ``torch.distributed`` against the JAX package's mesh.

Each world size (1, 2 and 4 ranks) is one spawn of CPU processes in a
``gloo`` group over a ``file://`` store; every rank runs all of the cases
below in one pass and writes its results to a file.  The same numpy inputs
go through the JAX package's ``parallel.mesh``/``cdc_mesh`` with the same
device count, on the 8 virtual CPU devices of ``tests/conftest.py``.  The
cases mirror ``tests/test_parallel_mesh.py``.  Outputs that the mesh
shards are joined in rank order; outputs that it replicates must be equal
on every rank.  Digests, roots, masks, bitmasks and tables are compared
exactly, as are the hashlib and host-tree oracles of the JAX tests.

Run alone, this file is the worker: ``python tests/test_torch_parallel_mesh.py
RANK WORLD STORE OUT``.
"""

import datetime
import hashlib
import os
import pickle
import random
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
# a rank's collectives give up after this; the spawn is killed after
# twice as long
RANK_TIMEOUT_S = 60
GEAR_STRIDE = 1 << 10
GEAR_ROWS = 16
GEAR_AVG_BITS = 8
SKETCH_LOG2_SLOTS = 9
# block counts of the digest_root_step cases: root32 at the ragged case's
# two blocks, so the JAX side compiles one program for both
CASE_BLOCKS = (("digest", None), ("root32", 2))


def _digest(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def _pack(payloads, nblocks=None):
    """Packed (B, nblocks, 16) hi/lo uint32 words and (B,) uint32 lengths,
    by the port's packer (equal to the JAX package's, test_torch_blake2b)."""
    from dat_replication_protocol_tpu_torch.ops import blake2b

    mh, ml, lengths = blake2b.pack_payloads(payloads, nblocks)
    return tuple(t.numpy().view(np.uint32) for t in (mh, ml, lengths))


def _digest_matrix(digests):
    """32-byte digests -> (N, 4) hi and lo uint32 words."""
    raw = np.frombuffer(b"".join(digests), dtype="<u4").reshape(-1, 8)
    return raw[:, 1::2].copy(), raw[:, 0::2].copy()


def _inputs() -> dict:
    """Every case's inputs, made from seeds; both sides take these."""
    out = {}
    out["digest"] = [b"payload-%03d" % i * (i + 1) for i in range(16)]
    out["root32"] = [_digest(b"x%d" % i) for i in range(32)]
    out["ragged"] = [b"item-%d" % i * (i + 1) for i in range(21)]
    a = [_digest(b"leaf-%d" % i) for i in range(64)]
    b = list(a)
    out["diff_changed"] = [0, 9, 33, 63]
    for i in out["diff_changed"]:
        b[i] = _digest(b"changed-%d" % i)
    out["diff"] = (a, b)
    data = random.Random(3).randbytes(GEAR_ROWS * GEAR_STRIDE)
    out["gear_data"] = data
    out["gear_rows"] = np.frombuffer(data, np.uint8).reshape(
        GEAR_ROWS, GEAR_STRIDE).view("<u4")
    out["gear_prefix"] = np.random.default_rng(5).integers(
        0, 1 << 32, 16, dtype=np.uint32)
    rng = np.random.default_rng(21)
    B = 203  # not a multiple of any mesh size above 1
    out["sketch"] = (rng.integers(0, 1 << 32, (B, 4), dtype=np.uint32),
                     rng.integers(0, 1 << 32, (B, 4), dtype=np.uint32),
                     rng.integers(0, 1 << SKETCH_LOG2_SLOTS, B,
                                  dtype=np.uint32))
    # cells that wrap: 61 records near 2**32 in 4 slots
    rng = np.random.default_rng(22)
    out["sketch_wrap"] = (
        rng.integers((1 << 32) - (1 << 20), 1 << 32, (61, 4),
                     dtype=np.uint32),
        rng.integers((1 << 32) - (1 << 20), 1 << 32, (61, 4),
                     dtype=np.uint32),
        rng.integers(0, 4, 61, dtype=np.uint32))
    out["hash"] = ([b"tiny-%d" % i for i in range(5)]
                   + [bytes([i]) * 300 for i in range(7)] + [b""])
    return out


# ---------------------------------------------------------------------------
# the worker: one rank of the port's mesh
# ---------------------------------------------------------------------------


def _rank_results(rank: int, world: int, store: str) -> dict:
    import torch
    import torch.distributed as dist

    from dat_replication_protocol_tpu_torch.parallel import (
        cdc_mesh, make_mesh, mesh as pmesh)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    def u32(t):
        return t.contiguous().numpy().view(np.uint32)

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        inp = _inputs()
        res = {"errors": {}}
        for n in (3, 1024, max(1, world // 2)):
            try:
                make_mesh(n, device="cpu")
                res["errors"][n] = None
            except ValueError as e:
                res["errors"][n] = str(e)
        mesh = make_mesh(device="cpu")
        res["mesh"] = (mesh.size, mesh.rank, str(mesh.device))

        for case, nblocks in CASE_BLOCKS:
            out = pmesh.digest_root_step(
                mesh, *(i32(a) for a in _pack(inp[case], nblocks)))
            res[case] = [u32(t) for t in out[:4]] + [out[4]]

        mh, ml, lengths, B = pmesh.pad_batch(
            mesh, *(i32(a) for a in _pack(inp["ragged"])))
        out = pmesh.digest_root_step(mesh, mh, ml, lengths)
        res["ragged"] = ([B, mh.shape[0]] + [u32(t) for t in out[:4]]
                         + [out[4]])

        a, b = inp["diff"]
        mask, ra, rb = pmesh.sharded_diff(
            mesh, *(i32(w) for w in _digest_matrix(a) + _digest_matrix(b)))
        res["diff"] = [mask.numpy(), *(u32(t) for t in ra + rb)]

        res["gear"] = u32(cdc_mesh.sharded_gear_scan(
            mesh, i32(inp["gear_rows"]), avg_bits=GEAR_AVG_BITS))
        res["gear_prefix"] = u32(cdc_mesh.sharded_gear_scan(
            mesh, i32(inp["gear_rows"]), prefix=inp["gear_prefix"],
            avg_bits=GEAR_AVG_BITS))

        for case in ("sketch", "sketch_wrap"):
            res[case] = u32(pmesh.sharded_sketch(
                mesh, *(i32(w) for w in inp[case]), SKETCH_LOG2_SLOTS))

        collect = pmesh.sharded_hash_begin(mesh, inp["hash"])
        collect.start_d2h()
        res["hash"] = collect()
        return res
    finally:
        dist.destroy_process_group()


def _worker(argv) -> None:
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    res = _rank_results(rank, world, store)
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _spawn(world: int, tmp: Path):
    """Start ``world`` ranks and a reaper thread that kills every rank
    still running ``2 * RANK_TIMEOUT_S`` after the start; returns a
    ``wait()`` that gives the ranks' result dicts in rank order."""
    store = tmp / "store"
    env = {**os.environ, "PYTHONPATH": str(REPO), "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(store),
         str(tmp / f"rank{r}.pkl")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + 2 * RANK_TIMEOUT_S
    logs: list = []

    def reap() -> None:
        try:
            for p in procs:
                left = max(0.0, deadline - time.monotonic())
                logs.append(p.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            logs.append(None)

    reaper = threading.Thread(target=reap)
    reaper.start()

    def wait() -> list[dict]:
        reaper.join()
        if logs[-1] is None:
            pytest.fail(f"world of {world} ranks passed its time limit")
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {world}:\n{log}"
        out = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return wait


# ---------------------------------------------------------------------------
# the reference: the JAX package's mesh at the same device count
# ---------------------------------------------------------------------------


def _jax_results(ndev: int) -> dict:
    import jax.numpy as jnp

    from dat_replication_protocol_tpu.parallel import cdc_mesh
    from dat_replication_protocol_tpu.parallel import mesh as pmesh

    inp = _inputs()
    mesh = pmesh.make_mesh(ndev)
    res = {}
    for case, nblocks in CASE_BLOCKS:
        out = pmesh.digest_root_step(
            mesh, *(jnp.asarray(a) for a in _pack(inp[case], nblocks)))
        res[case] = [np.asarray(t) for t in out[:4]] + [out[4]]
    mh, ml, lengths, B = pmesh.pad_batch(
        mesh, *(jnp.asarray(a) for a in _pack(inp["ragged"])))
    out = pmesh.digest_root_step(mesh, mh, ml, lengths)
    res["ragged"] = [B, mh.shape[0]] + [np.asarray(t) for t in out[:4]] + [
        out[4]]
    a, b = inp["diff"]
    mask, ra, rb = pmesh.sharded_diff(
        mesh, *(jnp.asarray(w) for w in _digest_matrix(a) + _digest_matrix(b)))
    res["diff"] = [np.asarray(mask), *(np.asarray(t) for t in ra + rb)]
    rows = jnp.asarray(inp["gear_rows"])
    res["gear"] = np.asarray(cdc_mesh.sharded_gear_scan(
        mesh, rows, avg_bits=GEAR_AVG_BITS))
    res["gear_prefix"] = np.asarray(cdc_mesh.sharded_gear_scan(
        mesh, rows, prefix=inp["gear_prefix"], avg_bits=GEAR_AVG_BITS))
    for case in ("sketch", "sketch_wrap"):
        res[case] = np.asarray(pmesh.sharded_sketch(
            mesh, *(jnp.asarray(w) for w in inp[case]), SKETCH_LOG2_SLOTS))
    res["hash"] = pmesh.sharded_hash_begin(mesh, inp["hash"])()
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every world's rank results and the JAX results at its device
    count: all worlds spawned at once, the JAX programs compiled in
    threads meanwhile."""
    waits = {n: _spawn(n, tmp_path_factory.mktemp(f"world{n}"))
             for n in WORLDS}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        refs = dict(zip(WORLDS, pool.map(_jax_results, WORLDS)))
    return {n: (waits[n](), refs[n]) for n in WORLDS}


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def world(request, results):
    return (request.param, *results[request.param])


def _joined(port, case, k):
    """The sharded output ``k`` of ``case``, joined in rank order."""
    return np.concatenate([r[case][k] for r in port])


def _replicated(port, case, k=None):
    """The replicated output, checked equal on every rank."""
    vals = [r[case] if k is None else r[case][k] for r in port]
    for v in vals[1:]:
        assert np.array_equal(np.asarray(v), np.asarray(vals[0]))
    return vals[0]


def test_make_mesh_errors_and_ranks(world):
    n, port, _ = world
    assert [r["mesh"] for r in port] == [(n, i, "cpu") for i in range(n)]
    for r in port:
        errs = r["errors"]
        assert "devices" in errs[1024]
        assert ("power of two" if n >= 3 else "devices") in errs[3]
        if n > 1:
            assert "spans its whole group" in errs[n // 2]
        else:
            assert errs[1] is None


@pytest.mark.parametrize("case", ["digest", "root32", "ragged"])
def test_digest_root_step_matches_jax_and_host(world, case):
    from dat_replication_protocol_tpu.ops import merkle

    n, port, ref = world
    inp = _inputs()
    off = 2 if case == "ragged" else 0
    if case == "ragged":
        assert [r[case][:2] for r in port] == [[21, 32]] * n
        assert ref[case][:2] == [21, 32]
    leaves = [_joined(port, case, off + k) for k in range(2)]
    for got, want in zip(leaves, ref[case][off:off + 2]):
        assert np.array_equal(got, want)
    root = [_replicated(port, case, off + k) for k in (2, 3)]
    for got, want in zip(root, ref[case][off + 2:off + 4]):
        assert np.array_equal(got, want)
    assert _replicated(port, case, off + 4) == ref[case][off + 4]
    payloads = inp[case]
    want = [_digest(p) for p in payloads]
    got = merkle.digests_from_device(*leaves)
    assert got[:len(payloads)] == want
    assert _replicated(port, case, off + 4) == sum(map(len, payloads))
    (dev_root,) = merkle.digests_from_device(*root)
    assert dev_root == merkle.host_tree(got)[-1][0]


def test_sharded_diff_matches_jax_and_host(world):
    from dat_replication_protocol_tpu.ops import merkle

    n, port, ref = world
    inp = _inputs()
    mask = _joined(port, "diff", 0)
    assert np.array_equal(mask, ref["diff"][0])
    assert np.nonzero(mask)[0].tolist() == inp["diff_changed"]
    for k in range(1, 5):
        assert np.array_equal(_replicated(port, "diff", k), ref["diff"][k])
    a, b = inp["diff"]
    roots = [merkle.digests_from_device(_replicated(port, "diff", k),
                                        _replicated(port, "diff", k + 1))[0]
             for k in (1, 3)]
    assert roots == [merkle.host_tree(a)[-1][0], merkle.host_tree(b)[-1][0]]


@pytest.mark.parametrize("case", ["gear", "gear_prefix"])
def test_sharded_gear_scan_matches_jax(world, case):
    from dat_replication_protocol_tpu.ops import rabin

    n, port, ref = world
    bits = np.concatenate([r[case] for r in port])
    assert np.array_equal(bits, ref[case])
    if case == "gear":
        got = []
        for t in range(GEAR_ROWS):
            dense = np.nonzero(np.unpackbits(bits[t].view(np.uint8),
                                             bitorder="little"))[0]
            local = dense - rabin.GROUP
            keep = (local >= 0) & (local < GEAR_STRIDE)
            got.extend((local[keep] + t * GEAR_STRIDE).tolist())
        assert got == rabin.host_candidates(_inputs()["gear_data"],
                                            GEAR_AVG_BITS)
    else:
        assert not np.array_equal(bits[0], ref["gear"][0])


@pytest.mark.parametrize("case", ["sketch", "sketch_wrap"])
def test_sharded_sketch_matches_jax_and_add_at(world, case):
    n, port, ref = world
    table = _replicated(port, case)
    assert np.array_equal(table, ref[case])
    rec_hh, rec_hl, slots = _inputs()[case]
    want = np.zeros((1 << SKETCH_LOG2_SLOTS, 8), dtype=np.uint32)
    np.add.at(want, slots, np.stack([rec_hl, rec_hh], axis=2).reshape(-1, 8))
    assert np.array_equal(table, want)
    if case == "sketch_wrap":
        wide = np.zeros(want.shape, dtype=np.uint64)
        np.add.at(wide, slots.astype(np.int64), np.stack(
            [rec_hl, rec_hh], axis=2).reshape(-1, 8).astype(np.uint64))
        assert (wide[:4] >= 1 << 32).all()


def test_sharded_hash_begin_matches_jax_and_hashlib(world):
    n, port, ref = world
    got = _replicated(port, "hash")
    assert got == ref["hash"] == [_digest(p) for p in _inputs()["hash"]]


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(sys.argv[1:])
