"""The port's card mutex against the JAX package's chip mutex.

Each scenario of ``tests/test_chiplock.py`` and of the chiplock metrics
cases in ``tests/test_obs_device.py`` runs through both packages'
``chip_lock``, each on its own lock file under ``tmp_path`` (the JAX
package's through ``DAT_CHIP_LOCK``, the port's through ``path=``).  A
holder subprocess imports only the package under test.  ``as_fields()``
must be equal in everything but ``waited_s``, which is a wall-clock
reading and must agree within ``WAIT_TOL`` seconds; the four
``device.chiplock.*`` metrics must be equal (the three counters and the
wait histogram's count exactly, its sum within ``WAIT_TOL``).
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

from dat_replication_protocol_tpu.obs import metrics as jax_metrics
from dat_replication_protocol_tpu.utils import chiplock as jax_chiplock
from dat_replication_protocol_tpu_torch.obs import metrics as port_metrics
from dat_replication_protocol_tpu_torch.utils import chiplock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_TOL = 1.0  # seconds between two wall-clock waits of one scenario
COUNTERS = ("device.chiplock.acquires", "device.chiplock.contended",
            "device.chiplock.lockless")

# a holder: take the lock, say so, keep it for argv[2] seconds (or until
# killed), then release it by leaving the block
_HOLDER = {
    "jax": (
        "import os, sys, time\n"
        "os.environ['DAT_CHIP_LOCK'] = sys.argv[1]\n"
        "from dat_replication_protocol_tpu.utils.chiplock import chip_lock\n"
        "with chip_lock(max_wait=0.1) as lease:\n"
        "    assert lease.held\n"
        "    print('HELD', flush=True)\n"
        "    time.sleep(float(sys.argv[2]))\n"),
    "port": (
        "import sys, time\n"
        "from dat_replication_protocol_tpu_torch.utils.chiplock import "
        "chip_lock\n"
        "with chip_lock(max_wait=0.1, path=sys.argv[1]) as lease:\n"
        "    assert lease.held\n"
        "    print('HELD', flush=True)\n"
        "    time.sleep(float(sys.argv[2]))\n"),
}


@pytest.fixture
def both_gates():
    """Both packages' obs gates on with clean registries; the prior gate
    states restored afterwards."""
    was = (jax_metrics.OBS.on, port_metrics.OBS.on)
    for m in (jax_metrics, port_metrics):
        m.REGISTRY.reset()
        m.enable()
    try:
        yield
    finally:
        jax_metrics.OBS.on, port_metrics.OBS.on = was
        for m in (jax_metrics, port_metrics):
            m.REGISTRY.reset()


def _holder(which: str, path: str, hold_s: float) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", _HOLDER[which], path,
                             str(hold_s)], stdout=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    assert proc.stdout.readline().strip() == "HELD"
    return proc


def _acquire(which: str, path: str, monkeypatch, held: bool, **kw) -> dict:
    """One ``chip_lock`` block whose lease must have ``held``: the lease's
    fields (stamped inside the block) and the seconds it took to open."""
    t0 = time.monotonic()
    if which == "jax":
        monkeypatch.setenv("DAT_CHIP_LOCK", path)
        cm = jax_chiplock.chip_lock(**kw)
    else:
        cm = chiplock.chip_lock(path=path, **kw)
    with cm as lease:
        opened = time.monotonic() - t0
        fields = lease.as_fields()
        json.dumps(fields)
        assert lease.held is held and lease.path == path
    return {"fields": fields, "opened_s": opened}


def _metrics(m) -> dict:
    snap = m.snapshot()
    h = snap["histograms"].get("device.chiplock.wait",
                               {"count": 0, "sum": 0.0})
    return {**{c: snap["counters"].get(c, 0) for c in COUNTERS},
            "wait": h["count"], "wait_sum": h["sum"]}


def _same(jax_out, port_out) -> None:
    """Equal fields but ``waited_s``, which must be within WAIT_TOL."""
    (jf, jm), (pf, pm) = jax_out, port_out
    jw = jf["chip_lock"].pop("waited_s")
    pw = pf["chip_lock"].pop("waited_s")
    assert pf == jf
    assert abs(pw - jw) <= WAIT_TOL, (pw, jw)
    assert abs(pm.pop("wait_sum") - jm.pop("wait_sum")) <= WAIT_TOL
    assert pm == jm


def _run(scenario, tmp_path, monkeypatch) -> dict:
    """``scenario(which, path)`` for each package on its own lock file,
    with that package's registry reset first; (fields, metrics) each."""
    out = {}
    for which, m in (("jax", jax_metrics), ("port", port_metrics)):
        m.REGISTRY.reset()
        path = str(tmp_path / f"{which}.lock")
        fields = scenario(which, path)
        out[which] = (fields, _metrics(m))
    _same(out["jax"], out["port"])
    return out["port"]


def test_lock_taken_at_once(tmp_path, monkeypatch, both_gates):

    def scenario(which, path):
        return _acquire(which, path, monkeypatch, True,
                        max_wait=1.0)["fields"]

    fields, m = _run(scenario, tmp_path, monkeypatch)
    assert fields == {"uncontended": True,
                      "chip_lock": {"held": True}}  # waited_s popped
    assert m["device.chiplock.acquires"] == 1
    assert m["device.chiplock.contended"] == 0
    assert m["wait"] == 1


def test_lock_taken_after_the_holder_exits(tmp_path, monkeypatch,
                                           both_gates):

    def scenario(which, path):
        proc = _holder(which, path, 2.0)
        try:
            got = _acquire(which, path, monkeypatch, True, max_wait=20.0,
                           poll_s=0.1)
        finally:
            proc.wait(timeout=30)
        assert 0.5 < got["opened_s"] < 15.0
        return got["fields"]

    fields, m = _run(scenario, tmp_path, monkeypatch)
    assert fields == {"uncontended": False, "chip_lock": {"held": True}}
    assert (m["device.chiplock.acquires"], m["device.chiplock.contended"],
            m["device.chiplock.lockless"]) == (1, 1, 0)


def test_lockless_after_max_wait_says_a_peer_is_active(tmp_path, monkeypatch,
                                                       both_gates):

    def scenario(which, path):
        proc = _holder(which, path, 60.0)
        try:
            got = _acquire(which, path, monkeypatch, False, max_wait=0.3,
                           poll_s=0.05)
            assert got["opened_s"] >= 0.3
            return got["fields"]
        finally:
            proc.kill()
            proc.wait(timeout=30)

    fields, m = _run(scenario, tmp_path, monkeypatch)
    assert fields == {"uncontended": False,
                      "chip_lock": {"held": False, "peer_active": True}}
    assert (m["device.chiplock.acquires"], m["device.chiplock.contended"],
            m["device.chiplock.lockless"]) == (0, 1, 1)
    assert m["wait"] == 1


def test_a_killed_holder_releases_the_lock(tmp_path, monkeypatch,
                                           both_gates):

    def scenario(which, path):
        proc = _holder(which, path, 60.0)
        proc.kill()  # SIGKILL: no __exit__, no unlock; the kernel drops it
        proc.wait(timeout=30)
        return _acquire(which, path, monkeypatch, True, max_wait=2.0,
                        poll_s=0.05)["fields"]

    fields, m = _run(scenario, tmp_path, monkeypatch)
    assert fields == {"uncontended": True, "chip_lock": {"held": True}}
    assert m["device.chiplock.acquires"] == 1


def test_an_unopenable_lock_file_runs_lockless_and_counts_it(
        tmp_path, monkeypatch, both_gates):

    def scenario(which, path):
        missing = os.path.join(os.path.dirname(path), "no-such-dir",
                               os.path.basename(path))
        return _acquire(which, missing, monkeypatch, False,
                        max_wait=1.0)["fields"]

    fields, m = _run(scenario, tmp_path, monkeypatch)
    assert fields == {"uncontended": False,
                      "chip_lock": {"held": False, "peer_active": False}}
    assert (m["device.chiplock.acquires"], m["device.chiplock.contended"],
            m["device.chiplock.lockless"]) == (0, 0, 1)
    assert m["wait"] == 0  # no wait was observed: the file never opened


def test_contention_from_another_descriptor_is_counted(tmp_path, monkeypatch,
                                                       both_gates):
    # flock excludes per open file description, so a second fd on the
    # same file in this process is a peer

    def scenario(which, path):
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return _acquire(which, path, monkeypatch, False, max_wait=0.2,
                            poll_s=0.05)["fields"]
        finally:
            os.close(fd)

    fields, m = _run(scenario, tmp_path, monkeypatch)
    assert fields["chip_lock"] == {"held": False, "peer_active": True}
    assert (m["device.chiplock.contended"],
            m["device.chiplock.lockless"]) == (1, 1)
    assert m["wait"] == 1


def test_gate_off_records_no_metric(tmp_path, monkeypatch):
    was = (jax_metrics.OBS.on, port_metrics.OBS.on)
    try:
        for m in (jax_metrics, port_metrics):
            m.disable()
            m.REGISTRY.reset()
        _acquire("jax", str(tmp_path / "j.lock"), monkeypatch, True,
                 max_wait=1.0)
        _acquire("port", str(tmp_path / "p.lock"), monkeypatch, True,
                 max_wait=1.0)
        assert _metrics(port_metrics) == _metrics(jax_metrics)
        assert _metrics(port_metrics)["device.chiplock.acquires"] == 0
    finally:
        jax_metrics.OBS.on, port_metrics.OBS.on = was


# -- the default path: one lock a card --------------------------------------

_SMI = "0, GPU-aaaa-0000\n1, GPU-bbbb-1111\n"


@pytest.fixture
def fake_smi(monkeypatch):
    """``nvidia-smi`` naming two cards, without running it."""
    def run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        return subprocess.CompletedProcess(cmd, 0, stdout=_SMI, stderr="")
    monkeypatch.setattr(chiplock.subprocess, "run", run)


@pytest.mark.parametrize("visible,want", [
    (None, "GPU-aaaa-0000"), ("0", "GPU-aaaa-0000"), ("1", "GPU-bbbb-1111"),
    ("1,0", "GPU-bbbb-1111"), ("0,1", "GPU-aaaa-0000"),
    ("GPU-bbbb", "GPU-bbbb-1111"), ("GPU-bbbb-1111,GPU-aaaa", "GPU-bbbb-1111"),
    ("GPU-aaaa,1", "GPU-aaaa-0000"), ("GPU", None), ("7", None), ("", None)])
def test_the_default_path_is_named_after_the_first_visible_card(
        visible, want, fake_smi, monkeypatch):
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert chiplock.card_uuid() == want
    name = f"dat_torch_chip-{want}.lock" if want else "dat_torch_chip.lock"
    assert chiplock.lock_path() == os.path.join(tempfile.gettempdir(), name)


def test_two_views_of_one_card_meet_on_one_lock(fake_smi, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    by_index = chiplock.lock_path()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,0")
    assert chiplock.lock_path() == by_index
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-bbbb-1111")
    assert chiplock.lock_path() == by_index
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert chiplock.lock_path() != by_index
    assert by_index != jax_chiplock.DEFAULT_LOCK_PATH


def test_no_nvidia_smi_is_one_lock_for_the_host(monkeypatch):
    def run(cmd, **kw):
        raise FileNotFoundError(cmd[0])
    monkeypatch.setattr(chiplock.subprocess, "run", run)
    assert chiplock.card_uuid() is None
    assert chiplock.lock_path() == os.path.join(tempfile.gettempdir(),
                                                "dat_torch_chip.lock")
