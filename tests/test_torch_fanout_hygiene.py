"""The fan-out and resume modules stand alone, as the rest of the port
does: the source scan of ``test_torch_hygiene.py`` covers them (every
file of the package is scanned), and a session through them, the
fan-out server, the fault injector, ``run_resumable`` on the CPU digest
decoder and the flight recorder, loads no module of the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dat_replication_protocol_tpu_torch"


def test_fanout_and_resume_modules_are_in_the_scan():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"fanout/server.py", "session/faults.py", "session/resume.py",
            "session/reconnect.py", "session/pump.py", "obs/flight.py",
            "sidecar.py"} <= names


def test_fanout_and_resume_sessions_load_no_jax_package_module(tmp_path):
    code = (
        "import sys\n"
        "import dat_replication_protocol_tpu_torch as protocol\n"
        "from dat_replication_protocol_tpu_torch import sidecar\n"
        "from dat_replication_protocol_tpu_torch.fanout import FanoutServer\n"
        "from dat_replication_protocol_tpu_torch.obs import flight\n"
        "from dat_replication_protocol_tpu_torch.session import (\n"
        "    BackoffPolicy, FaultPlan, FaultyReader, WireJournal,\n"
        "    run_resumable)\n"
        "from dat_replication_protocol_tpu_torch.session.faults import (\n"
        "    bytes_reader)\n"
        f"flight.FLIGHT.arm({str(tmp_path)!r})\n"
        "e = protocol.encode()\n"
        "j = WireJournal()\n"
        "e.attach_journal(j)\n"
        "for i in range(20):\n"
        "    e.change({'key': 'k%d' % i, 'change': i, 'from': 0, 'to': 1})\n"
        "e.blob(300).end(b'b' * 300)\n"
        "e.finalize()\n"
        "while e.read(64) is not None:\n"
        "    pass\n"
        "wire = j.read_from(0)\n"
        "srv = FanoutServer(stall_timeout=5.0)\n"
        "got = bytearray()\n"
        "peer = srv.attach_peer('p', sink=lambda vs: (got.extend(\n"
        "    b''.join(bytes(v) for v in vs)), sum(map(len, vs)))[1])\n"
        "d = protocol.decode(backend='cuda', device='cpu')\n"
        "digests = []\n"
        "d.on_digest(lambda k, s, x: digests.append(x))\n"
        "run_resumable(lambda ck, f: FaultyReader(\n"
        "    bytes_reader(j.read_from(ck.wire_offset)),\n"
        "    FaultPlan(drop_at=100 if f == 0 else None)), d,\n"
        "    BackoffPolicy(base=0.0), expected_total=len(wire))\n"
        "srv.publish(wire)\n"
        "srv.seal()\n"
        "assert srv.drain(10) and bytes(got) == wire and len(digests) == 21\n"
        "assert flight.FLIGHT.last_bundle.endswith('recovered')\n"
        "srv.close()\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'dat_replication_protocol_tpu')\n"
        "print(loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
