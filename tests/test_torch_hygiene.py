"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

The image preloads the ``jax`` module into every interpreter, so "the
port never imports JAX" is proven on the source (an AST scan of every
file of the port and of ``chip_smoke.py``) and, at run time, by the
absence of every module of the JAX *package* after a port session.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    DigestPipeline,
)
from dat_replication_protocol_tpu_torch.batch import feed
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.wire import batch_codec
from dat_replication_protocol_tpu_torch.ops import (
    blake2b,
    fused_cdc_hash,
    merkle,
    rabin_cuda,
    rateless,
    reconcile,
)
from dat_replication_protocol_tpu_torch import weights
from dat_replication_protocol_tpu_torch.hub import ReplicationHub
from dat_replication_protocol_tpu_torch.parallel import mesh as pmesh
from dat_replication_protocol_tpu_torch.runtime import (
    reconcile_driver,
    snapshot_driver,
)
from dat_replication_protocol_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dat_replication_protocol_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dat_replication_protocol_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    assert len(_port_files()) > 15
    bad = [f"{p.relative_to(REPO)}:{line} imports {name}"
           for p in _port_files() for line, name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_triton_is_never_imported_at_module_level():
    # kernels are built and imported at first launch: a module-level
    # import of triton would break every host without it
    for p in _port_files():
        tree = ast.parse(p.read_text())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(n and n.startswith("triton") for n in names), p


def test_port_session_loads_no_jax_package_module():
    code = (
        "import sys\n"
        "import dat_replication_protocol_tpu_torch as protocol\n"
        "from dat_replication_protocol_tpu_torch import entry, sidecar, weights\n"
        "from dat_replication_protocol_tpu_torch.ops import merkle\n"
        "e = protocol.encode()\n"
        "d = protocol.decode(backend='cuda', device='cpu')\n"
        "got = []\n"
        "d.on_digest(lambda k, s, x: got.append(x))\n"
        "protocol.pipe(e, d)\n"
        "e.change({'key': 'k', 'change': 1, 'from': 0, 'to': 1})\n"
        "e.blob(3).end(b'abc')\n"
        "e.finalize()\n"
        "fn, args = entry.entry(device='cpu')\n"
        "fn(*args)\n"
        "assert len(got) == 2 and d.finished\n"
        "import numpy as np\n"
        "from dat_replication_protocol_tpu_torch.ops import rateless, reconcile\n"
        "from dat_replication_protocol_tpu_torch.runtime.tree_sync import (\n"
        "    TreeSyncSession, sync)\n"
        "keys = [b'k%03d' % i for i in range(64)]\n"
        "sa = reconcile.LogSummary([b'v' + k for k in keys], keys, 6,\n"
        "                          device='cpu')\n"
        "sb = reconcile.LogSummary([b'v' + k for k in keys[1:]], keys[1:], 6,\n"
        "                          device='cpu')\n"
        "slots = reconcile.reconcile(sa, sb)['slots'].tolist()\n"
        "ta, tb = (TreeSyncSession(*merkle.build_tree(\n"
        "    *reconcile.table_leaves(s.table))) for s in (sa, sb))\n"
        "assert sync(ta, tb) == slots == [int(sa.slots[0])]\n"
        "a = merkle.digests_to_device([bytes(32)] * 2, device='cpu')\n"
        "b = merkle.digests_to_device([bytes(32), bytes([1]) * 32],\n"
        "                             device='cpu')\n"
        "assert merkle.diff_snapshots(*a, *b).tolist() == [1]\n"
        "d = np.random.default_rng(0).integers(0, 256, (64, 32),\n"
        "                                      dtype=np.uint8)\n"
        "dec = rateless.PeelDecoder(d[1:], device='cpu')\n"
        "dec.add_symbols(0, rateless.CodedSymbols(d, device='cpu').extend(16))\n"
        "assert dec.try_decode()[0].tolist() == [d[0].tolist()]\n"
        "from dat_replication_protocol_tpu_torch.batch import feed\n"
        "from dat_replication_protocol_tpu_torch.runtime import replay\n"
        "e = protocol.encode(peer_caps=protocol.CAP_CHANGE_BATCH)\n"
        "e.change_many([{'key': 'k%d' % i, 'change': i, 'from': 0,\n"
        "                'to': 1} for i in range(9)])\n"
        "e.finalize()\n"
        "cols, frames = replay.replay_log(e.read())\n"
        "assert len(feed.leaves_from_columns(cols, frames,\n"
        "                                    device='cpu')) == 9\n"
        "import hashlib, tempfile\n"
        "import torch.distributed as dist\n"
        "from dat_replication_protocol_tpu_torch.ops import blake2b\n"
        "from dat_replication_protocol_tpu_torch.parallel import (\n"
        "    make_mesh, sharded_gear_scan, sharded_hash_begin)\n"
        "want = hashlib.blake2b(b'abc', digest_size=32).digest()\n"
        "s = blake2b.Blake2bStream(segment_bytes=128, device='cpu')\n"
        "assert s.update(b'abc').digest() == want\n"
        "dist.init_process_group('gloo', rank=0, world_size=1,\n"
        "    init_method='file://' + tempfile.mkdtemp() + '/store')\n"
        "m = make_mesh(device='cpu')\n"
        "assert sharded_hash_begin(m, [b'abc'])() == [want]\n"
        "import torch\n"
        "rows = torch.zeros((2, 64), dtype=torch.int32)\n"
        "assert sharded_gear_scan(m, rows).shape == (2, 16)\n"
        "dist.destroy_process_group()\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'dat_replication_protocol_tpu')\n"
        "print(loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO),
                              "GLOO_SOCKET_IFNAME": "lo"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.mark.parametrize("make", [
    lambda: protocol.decode(backend="cuda"),
    lambda: protocol.encode(backend="cuda"),
    lambda: DigestPipeline(),
    lambda: resolve_device(),
    lambda: resolve_device("cuda:0"),
    lambda: protocol.content_address(b"abc"),
    lambda: protocol.content_digests(b"abc"),
    lambda: protocol.chunk_stream(b"abc"),
    lambda: merkle.diff_leaves([bytes(32)], [bytes(32)]),
    lambda: reconcile.LogSummary([b"r"], [b"k"], 4),
    lambda: reconcile.LogSummary([], [], 4),
    lambda: rateless.CodedSymbols(np.zeros((1, 32), np.uint8)),
    lambda: rateless.PeelDecoder(np.zeros((1, 32), np.uint8)),
    lambda: rateless.WeightedSymbols(np.zeros((1, 32), np.uint8), [1]),
    lambda: rateless.build_symbols_device(np.zeros((1, 11), np.uint32),
                                          np.zeros(1, np.int64),
                                          np.zeros(1, np.int64), 1),
    lambda: feed.leaves_from_columns(*replay.replay_log(b"")),
    lambda: feed.leaves_from_columns(replay.replay_log(b"")[0]),
    lambda: feed.leaves_from_change_columns(replay.replay_log(b"")[0]),
    lambda: feed.decode_batch_device(batch_codec.encode_rows([])),
    lambda: protocol.encode(backend="cuda",
                            peer_caps=protocol.CAP_CHANGE_BATCH),
    lambda: blake2b.initial_state(1),
    lambda: blake2b.Blake2bStream(),
    lambda: pmesh.make_mesh(),
    lambda: pmesh.make_mesh(1),
    lambda: reconcile_driver.RatelessReplica(b""),
    lambda: snapshot_driver.SnapshotSource(b"abc"),
    lambda: snapshot_driver.SnapshotJoiner(),
    lambda: snapshot_driver.snapshot_local(b"abc"),
    lambda: weights.snapshot_source_from_numpy(b"abc", [3],
                                               np.zeros((1, 32), np.uint8)),
    lambda: ReplicationHub(),
], ids=["decode", "encode", "pipeline", "resolve", "resolve-index",
        "content-address", "content-digests", "chunk-stream", "diff-leaves",
        "log-summary", "log-summary-empty", "coded-symbols", "peel-decoder",
        "weighted-symbols", "build-symbols", "leaves-frames",
        "leaves-rows", "leaves-canonical", "decode-batch-device",
        "encode-negotiated", "initial-state", "blake2b-stream", "make-mesh",
        "make-mesh-1", "rateless-replica", "snapshot-source",
        "snapshot-joiner", "snapshot-local", "snapshot-source-weights",
        "hub"])
def test_cuda_without_a_card_raises(make):
    _no_card()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make()


def test_resolve_device_names_cpu_and_refuses_others():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device type"):
        resolve_device("meta")


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="unknown backend"):
        protocol.decode(backend="tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        protocol.encode(backend="gpu")


def test_kernel_wrappers_refuse_other_devices():
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel, blake2b_update_kernel)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    words = torch.zeros((2, 1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        blake2b_packed_kernel(words, words, torch.zeros(
            2, dtype=torch.int32, device="meta"))
    state = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    count = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        blake2b_update_kernel(state, state, count, count, words, words, count,
                              torch.zeros(2, dtype=torch.bool, device="meta"))
    digests = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        merkle_level_kernel(digests, digests)


@pytest.mark.parametrize("call", [
    lambda rows: rabin_cuda.gear_candidates_kernel(rows, 13),
    lambda rows: rabin_cuda.gear_first_kernel(rows, 13),
    lambda rows: rabin_cuda.gear_window_first_kernel(rows, 13, 8),
    lambda rows: fused_cdc_hash.gear_window_first_checked_kernel(rows, 13, 8),
], ids=["B3", "B4", "B5", "B6"])
def test_gear_wrappers_refuse_other_devices(call):
    rows = torch.zeros((2, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        call(rows)


def test_new_modules_are_in_the_scan():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"ops/rabin.py", "ops/rabin_cuda.py", "ops/fused_cdc_hash.py",
            "batch/feed.py", "runtime/content.py", "ops/reconcile.py",
            "ops/rateless.py", "runtime/tree_sync.py", "wire/batch_codec.py",
            "runtime/replay.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/cdc_mesh.py", "obs/__init__.py", "obs/metrics.py",
            "obs/events.py", "obs/tracing.py", "obs/flight.py",
            "obs/device.py", "utils/trace.py"} <= names


@pytest.mark.parametrize("backend,device", [("nccl", "cpu"),
                                            ("gloo", "cuda")])
def test_mesh_refuses_a_backend_that_cannot_hold_its_device(
        backend, device, monkeypatch):
    # make_mesh resolves the device, then checks the group's backend
    # before it touches the group; the card is faked for the gloo case
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(pmesh, "resolve_device", torch.device)
    with pytest.raises(ValueError, match=f"a {backend} group cannot hold"):
        pmesh.make_mesh(1, device=device)


def test_port_reads_no_cdc_environment_switch():
    # the reference's DAT_CDC_ROUTE / DAT_CDC_FIRST_KERNEL / DAT_DEVICE_CDC
    # are arguments in the port
    for p in sorted(PORT.rglob("*.py")):
        text = p.read_text()
        assert "DAT_CDC" not in text and "DAT_DEVICE_CDC" not in text, p
        assert "os.environ" not in text and "getenv" not in text, p


@pytest.mark.parametrize("alone", [False, True], ids=["no-card", "alone"])
def test_chip_smoke_fails_without_card_or_repo(alone, tmp_path):
    _no_card()
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=cwd, env=env)
    assert out.returncode != 0
    assert out.stdout == ""


def test_anti_entropy_modules_are_in_the_scan():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"wire/reconcile_codec.py", "wire/snapshot_codec.py",
            "session/transport.py", "session/pump.py",
            "session/reconnect.py", "session/resume.py",
            "obs/watermarks.py", "fanout/__init__.py", "fanout/log.py",
            "runtime/reconcile_driver.py", "runtime/snapshot_driver.py",
            "sidecar.py", "weights.py"} <= names


def test_anti_entropy_sessions_load_no_jax_package_module():
    code = (
        "import socket, sys, threading\n"
        "import numpy as np\n"
        "from dat_replication_protocol_tpu_torch import sidecar, weights\n"
        "from dat_replication_protocol_tpu_torch.fanout import BroadcastLog\n"
        "from dat_replication_protocol_tpu_torch.obs.watermarks import (\n"
        "    WATERMARKS)\n"
        "from dat_replication_protocol_tpu_torch.runtime import (\n"
        "    reconcile_driver as rd, replay, snapshot_driver as sd)\n"
        "recs = [{'key': 'k%d' % i, 'change': i, 'from': 0, 'to': 1}\n"
        "        for i in range(40)]\n"
        "a = rd.RatelessReplica(recs[:38], device='cpu')\n"
        "b = rd.RatelessReplica(recs[2:], device='cpu')\n"
        "assert len(rd.reconcile_local(a, b)['a_rows']) == 2\n"
        "data = np.random.default_rng(0).integers(0, 256, 50000,\n"
        "                                         dtype=np.uint8)\n"
        "src = sd.SnapshotSource(data, device='cpu')\n"
        "ready = threading.Event()\n"
        "port = []\n"
        "t = threading.Thread(target=sidecar.serve_tcp, daemon=True,\n"
        "    args=('127.0.0.1', 0), kwargs={'max_sessions': 1,\n"
        "    'snapshot_source': src, 'device': 'cpu',\n"
        "    'ready_cb': lambda p: (port.append(p), ready.set())})\n"
        "t.start()\n"
        "assert ready.wait(30)\n"
        "s = socket.create_connection(('127.0.0.1', port[0]), timeout=30)\n"
        "res = sd.run_snapshot_joiner(s.recv, s.sendall,\n"
        "    lambda: s.shutdown(socket.SHUT_WR), device='cpu')\n"
        "assert res['data'] == data.tobytes()\n"
        "s.close()\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'dat_replication_protocol_tpu')\n"
        "print(loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_hub_modules_are_in_the_scan():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"hub/__init__.py", "hub/engine.py", "obs/wirecost.py",
            "obs/http.py", "obs/events.py", "session/pump.py"} <= names


def test_hub_sessions_load_no_jax_package_module():
    code = (
        "import json, os, sys, urllib.request\n"
        "import dat_replication_protocol_tpu_torch as protocol\n"
        "from dat_replication_protocol_tpu_torch import sidecar\n"
        "from dat_replication_protocol_tpu_torch.hub import ReplicationHub\n"
        "from dat_replication_protocol_tpu_torch.obs import http, metrics\n"
        "metrics.enable()\n"
        "hub = ReplicationHub(device='cpu')\n"
        "sidecar.set_active_hub(hub)\n"
        "s = hub.register('k')\n"
        "d = protocol.decode(backend='cuda', pipeline=s)\n"
        "got = []\n"
        "d.on_digest(lambda k, q, x: got.append(x))\n"
        "e = protocol.encode()\n"
        "protocol.pipe(e, d)\n"
        "e.change({'key': 'k', 'change': 1, 'from': 0, 'to': 1})\n"
        "e.blob(3).end(b'abc')\n"
        "e.finalize()\n"
        "assert len(got) == 2 and d.finished\n"
        "r, w = os.pipe()\n"
        "assert sidecar.StatsEmitter(w).dump_once()\n"
        "assert json.loads(os.read(r, 1 << 20))['sessions']['k']\n"
        "srv = http.ObsHttpServer(0, snapshot_fn=sidecar.snapshot_stats,\n"
        "                         admission_fn=hub.admission_state).start()\n"
        "urllib.request.urlopen(srv.url + '/healthz', timeout=30).read()\n"
        "srv.close()\n"
        "s.close()\n"
        "hub.close()\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'dat_replication_protocol_tpu')\n"
        "print(loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_obs_cli_modules_are_in_the_scan():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"obs/fleet.py", "obs/__main__.py"} <= names


def test_python_m_obs_loads_no_jax_package_module(tmp_path):
    # every subcommand's module imports at the CLI's start, so one run
    # covers them all: the CLI and fleet (imported by fleet)
    slo = tmp_path / "slo.json"
    slo.write_text('{"max_shed": 0}')
    code = (
        "import runpy, sys\n"
        "from dat_replication_protocol_tpu_torch.obs import fleet\n"
        "sys.argv = ['obs', 'fleet', sys.argv[1], '--check', sys.argv[2],\n"
        "            '--polls', '1']\n"
        "try:\n"
        "    runpy.run_module('dat_replication_protocol_tpu_torch.obs',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'dat_replication_protocol_tpu')\n"
        "print(loaded, file=sys.stderr)\n"
    )
    target = tmp_path / "stats.jsonl"
    target.write_text('{"watermarks": {"links": {}}}\n')
    out = subprocess.run([sys.executable, "-c", code, str(target), str(slo)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "fleet-check: 1 check(s), 0 failed" in out.stdout
    assert out.stderr.strip().splitlines()[-1] == "[]"


def test_native_sources_are_the_ports_own_copies():
    # the host libraries build from the port's own native/ sources: no
    # #include and no path reaches into the JAX package's native/
    from dat_replication_protocol_tpu_torch.runtime import fastpath, native

    for mod in (native, fastpath):
        assert PORT / "native" in mod.SOURCE.parents
    c_files = sorted((PORT / "native").glob("*.cpp")) + sorted(
        (PORT / "csrc").glob("*.cu*"))
    assert {p.name for p in c_files} >= {"dat_native.cpp",
                                         "dat_fastpath.cpp"}
    jax_native = ("dat_replication_protocol_tpu/native",
                  "dat_replication_protocol_tpu\\native")
    for p in c_files:
        for line in p.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                target = line.split("#include", 1)[1].strip()
                assert target.startswith("<") or "/" not in target, (p, line)
                assert ".." not in target, (p, line)
    for p in sorted(PORT.rglob("*")):
        if p.suffix in (".py", ".cpp", ".cu", ".cuh", ".h"):
            text = p.read_text()
            assert not any(j in text for j in jax_native), p
