"""The port's hub on a mesh: batches sharded over ``torch.distributed``.

Each world size (1 and 2 ranks) is one spawn of CPU processes in a
``gloo`` group over a ``file://`` store.  Rank 0 runs a
``ReplicationHub(mesh="auto")`` with three concurrent digest sessions;
rank 1 runs ``mesh_follower`` and must leave on the hub's ``close()``.
Every session's digests must equal ``hashlib``'s and the JAX package's
decoder's for the same wire.  A third spawn fails rank 0's engine
between a batch's broadcast and its gather: every session must see
``HubError`` and the follower, left inside the batch, must raise and
exit instead of waiting.  Then: ``mesh=`` without a process group
raises (no fallback to one device), and the sidecar's ``--hub-mesh``
exits with the error without a launcher's group, serves through a
two-rank group when one is set up (``env://``), and ends both ranks
with exit code 1 when rank 0's engine fails mid-batch.

Run alone, this file is the worker: ``python tests/test_torch_hub_mesh.py
RANK WORLD STORE OUT [fail]``, or ``... sidecar-fail ARGS`` for a sidecar
whose mesh engine raises on its first batch.
"""

import datetime
import gc
import hashlib
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
WORLDS = (1, 2)
RANK_TIMEOUT_S = 60
N_SESSIONS = 3


def _digest(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def _wire(i: int) -> bytes:
    import dat_replication_protocol_tpu_torch as protocol

    e = protocol.encode()
    for j in range(20 + i):
        e.change({"key": f"m{i}-{j}", "change": j, "from": 0, "to": 1,
                  "value": b"v" * (j % 7) + bytes([i])})
    b = e.blob(300 + i)
    b.end(bytes([(i + k) % 256 for k in range(300 + i)]))
    e.finalize()
    return b"".join(iter(lambda: e.read(4096) or b"", b""))


def _failing_rank(rank: int, released: Path) -> dict:
    """The fault arm: rank 0's engine raises after the first batch's
    payloads reached the follower, before the gather that closes it.
    The follower marks ``released`` when its collective raises.  Rank 0
    drops the failed hub and waits for the mark before it exits: the
    group's connections close once the hub has torn it down and nothing
    holds it, so only that teardown can have released the follower."""
    import torch.distributed as dist

    from dat_replication_protocol_tpu_torch.hub import (HubError,
                                                        ReplicationHub,
                                                        mesh_follower)
    from dat_replication_protocol_tpu_torch.parallel import make_mesh
    from dat_replication_protocol_tpu_torch.parallel import mesh as pmesh

    if rank != 0:
        try:
            mesh_follower(make_mesh(device="cpu"))
        except RuntimeError as e:
            released.touch()
            return {"follower_error": str(e)}
        return {"follower_error": None}

    def fail(mesh, payloads):
        raise RuntimeError("B1 did not launch")

    pmesh.sharded_hash_begin = fail
    hub = ReplicationHub(mesh="auto", device="cpu", linger_s=0.002)
    errors: dict = {}

    def run_one(i):
        s = hub.register(f"m{i}")
        try:
            for j in range(4):
                s.submit(bytes([i, j]) * 50, lambda d: None)
            s.flush()
        except HubError as e:
            errors[i] = str(e)

    threads = [threading.Thread(target=run_one, args=(i,))
               for i in range(N_SESSIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(RANK_TIMEOUT_S)
    hub.close()
    torn_down = not dist.is_initialized()
    del hub
    gc.collect()
    deadline = time.monotonic() + RANK_TIMEOUT_S / 3
    while not released.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    return {"errors": errors, "torn_down": torn_down,
            "released": released.exists()}


def _rank_results(rank: int, world: int, store: str, mode: str) -> dict:
    import torch.distributed as dist

    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.hub import (ReplicationHub,
                                                        mesh_follower)
    from dat_replication_protocol_tpu_torch.parallel import make_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        if mode == "fail":
            return _failing_rank(rank, Path(store).parent / "released")
        if rank != 0:
            return {"followed": mesh_follower(make_mesh(device="cpu"))}
        hub = ReplicationHub(mesh="auto", device="cpu", linger_s=0.002)
        out: dict = {}

        def run_one(i):
            s = hub.register(f"m{i}")
            dec = protocol.decode(backend="cuda", pipeline=s)
            digs = []
            dec.on_digest(lambda kind, seq, d: digs.append((kind, seq, d)))
            wire = _wire(i)
            for off in range(0, len(wire), 211):
                dec.write(wire[off:off + 211])
            dec.end()
            out[i] = (dec.finished, digs)
            s.close()

        threads = [threading.Thread(target=run_one, args=(i,))
                   for i in range(N_SESSIONS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(RANK_TIMEOUT_S)
        res = {"mesh": (hub.mesh.size, hub.mesh.rank),
               "dispatches": hub._pipeline.dispatches,
               "sessions": out}
        hub.close()
        return res
    finally:
        if dist.is_initialized():  # a failed hub tears its group down
            dist.destroy_process_group()


def _worker(argv) -> None:
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    res = _rank_results(rank, world, store, argv[4] if argv[4:] else "")
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _spawn(world: int, tmp: Path, mode: str = "") -> list:
    env = {**os.environ, "PYTHONPATH": str(REPO), "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp / "store"),
         str(tmp / f"rank{r}.pkl"), mode], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=2 * RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log}"
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _reference_digests(i: int) -> list:
    import dat_replication_protocol_tpu as jax_protocol

    dec = jax_protocol.decode(backend="tpu")
    digs: list = []
    dec.on_digest(lambda kind, seq, d: digs.append((kind, seq, d)))
    dec.write(_wire(i))
    dec.end()
    return digs


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"world{w}")
def test_mesh_hub_digests_and_follower(world, tmp_path):
    from dat_replication_protocol_tpu_torch.wire.change_codec import (
        encode_change)

    ranks = _spawn(world, tmp_path)
    lead = ranks[0]
    assert lead["mesh"] == (world, 0)
    for i in range(N_SESSIONS):
        finished, digs = lead["sessions"][i]
        assert finished
        assert digs == _reference_digests(i)
        changes = [d for kind, _, d in digs if kind == "change"]
        assert changes == [_digest(encode_change({
            "key": f"m{i}-{j}", "change": j, "from": 0, "to": 1,
            "value": b"v" * (j % 7) + bytes([i])})) for j in range(20 + i)]
        assert [d for kind, _, d in digs if kind == "blob"] == [_digest(
            bytes([(i + k) % 256 for k in range(300 + i)]))]
    if world > 1:
        # the follower made the same call for every batch, then left
        assert ranks[1]["followed"] == lead["dispatches"] > 0


def test_mesh_hub_failure_mid_batch_releases_the_follower(tmp_path):
    t0 = time.monotonic()
    lead, follower = _spawn(2, tmp_path, "fail")
    assert sorted(lead["errors"]) == list(range(N_SESSIONS))
    assert all("B1 did not launch" in e for e in lead["errors"].values())
    # the follower raised on the torn-down group while rank 0 was still
    # up, well before its own collective timeout would have ended the wait
    assert lead["torn_down"]
    assert lead["released"]
    assert follower["follower_error"]
    assert time.monotonic() - t0 < RANK_TIMEOUT_S


def test_mesh_without_a_process_group_raises():
    import torch.distributed as dist

    from dat_replication_protocol_tpu_torch.hub import ReplicationHub

    assert not dist.is_initialized()
    for mesh in ("auto", 1):
        with pytest.raises(RuntimeError, match="initialized process group"):
            ReplicationHub(mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh= or hash_begin="):
        ReplicationHub(mesh="auto", device="cpu", hash_begin=lambda p: None)


def test_mesh_hub_runs_on_rank_zero_only():
    import torch

    from dat_replication_protocol_tpu_torch.hub import (ReplicationHub,
                                                        mesh_follower)
    from dat_replication_protocol_tpu_torch.parallel import Mesh

    rank1 = Mesh(None, 2, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh_follower"):
        ReplicationHub(mesh=rank1)
    with pytest.raises(ValueError, match="rank 0 runs the hub"):
        mesh_follower(Mesh(None, 2, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="'auto', an int or a Mesh"):
        ReplicationHub(mesh="all", device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sidecar(args, env_extra=None, fail=False, **kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
               **(env_extra or {}))
    cmd = ([__file__, "sidecar-fail"] if fail else
           ["-m", "dat_replication_protocol_tpu_torch.sidecar"])
    return subprocess.Popen(
        [sys.executable, *cmd, *args], env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, **kw)


def _failing_sidecar(args) -> int:
    """A sidecar whose mesh engine raises on its first batch, after the
    payloads reached the followers."""
    from dat_replication_protocol_tpu_torch import sidecar
    from dat_replication_protocol_tpu_torch.parallel import mesh as pmesh

    def fail(mesh, payloads):
        raise RuntimeError("B1 did not launch")

    pmesh.sharded_hash_begin = fail
    return sidecar.main(args)


def _two_rank_sidecars(fail=False) -> list:
    master = str(_free_port())
    return [_sidecar(["--tcp", "127.0.0.1:0", "--hub", "--hub-mesh", "2",
                      "--device", "cpu"],
                     {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": master,
                      "RANK": str(r), "WORLD_SIZE": "2"}, fail=fail)
            for r in range(2)]


def _listening_port(proc) -> int:
    seen = []
    while not seen or "listening on" not in seen[-1]:
        line = proc.stderr.readline()
        assert line and len(seen) < 50, "".join(seen)
        seen.append(line)
    return int(seen[-1].rsplit(":", 1)[1])


def _exchange(port: int, wire: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(wire)
        s.shutdown(socket.SHUT_WR)
        return b"".join(iter(lambda: s.recv(65536), b""))


def _reap(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stderr.close()


def test_sidecar_hub_mesh_needs_a_launchers_group():
    p = _sidecar(["--tcp", "127.0.0.1:0", "--hub", "--hub-mesh", "auto",
                  "--device", "cpu"])
    _, err = p.communicate(timeout=120)
    assert p.returncode == 2
    assert "--hub-mesh needs the process group" in err
    assert "listening" not in err


def test_sidecar_hub_mesh_serves_through_a_two_rank_group():
    import dat_replication_protocol_tpu_torch as protocol

    procs = _two_rank_sidecars()
    try:
        reply = _exchange(_listening_port(procs[0]), _wire(1))
        got = []
        dec = protocol.decode()
        dec.change(lambda c, done: (got.append(bytes(c.value)), done()))
        dec.write(reply)
        dec.end()
        assert got == [d for _, _, d in _reference_digests(1)]
        procs[0].send_signal(signal.SIGINT)  # rank 0 closes its hub
        for p in procs:
            p.wait(timeout=60)
        err1 = procs[1].stderr.read()
        assert procs[1].returncode == 0, err1
        assert "rank 1 followed" in err1
    finally:
        _reap(procs)


def test_sidecar_hub_mesh_failure_ends_both_ranks():
    import dat_replication_protocol_tpu_torch as protocol

    procs = _two_rank_sidecars(fail=True)
    try:
        reply = _exchange(_listening_port(procs[0]), _wire(2))
        got = []
        dec = protocol.decode()
        dec.change(lambda c, done: (got.append(c), done()))
        dec.write(reply)
        dec.end()
        assert got == []  # torn down before any digest came back
        # no signal from here: each rank ends on its own
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
        err0, err1 = procs[0].stderr.read(), procs[1].stderr.read()
        assert procs[0].returncode == 1, err0
        assert "the mesh hub failed" in err0 and "B1 did not launch" in err0
        assert procs[1].returncode == 1, err1
        assert "rank 1: the hub's group failed" in err1
    finally:
        _reap(procs)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["sidecar-fail"]:
        sys.exit(_failing_sidecar(sys.argv[2:]))
    _worker(sys.argv[1:])
