"""The port's flight recorder on the resume paths, against the JAX
package's: the cap on routine dumps, ``dump(checkpoint=)``, the
decoder's protocol-error bundle with its checkpoint, and the bundle a
recovered ``run_resumable`` session leaves (its checkpoint and the fault
plans the injector noted).  The manifests must agree field for field,
apart from the clock and the process id.
"""

import json
import os

import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.obs import flight as jflight
from dat_replication_protocol_tpu.obs import metrics as jmetrics
from dat_replication_protocol_tpu.session import faults as jfaults
from dat_replication_protocol_tpu.session import reconnect as jreconnect
from dat_replication_protocol_tpu.wire.framing import (
    ProtocolError as JProtocolError)
from dat_replication_protocol_tpu_torch.obs import flight as pflight
from dat_replication_protocol_tpu_torch.obs import metrics as pmetrics
from dat_replication_protocol_tpu_torch.session import faults as pfaults
from dat_replication_protocol_tpu_torch.session import reconnect as preconnect
from dat_replication_protocol_tpu_torch.session.resume import (
    SessionCheckpoint)
from dat_replication_protocol_tpu_torch.wire.framing import (ProtocolError,
                                                           iter_frames)

SIDES = {"port": (protocol, pflight, pfaults, preconnect, pmetrics),
         "jax": (jax_protocol, jflight, jfaults, jreconnect, jmetrics)}
_CLOCK = ("ts", "monotonic", "clock", "pid", "events_dropped",
          "spans_dropped")


@pytest.fixture(autouse=True)
def _recorders(monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    state = {name: s[4].OBS.on for name, s in SIDES.items()}
    for s in SIDES.values():
        s[1].FLIGHT._reset_for_tests()
    yield
    for name, s in SIDES.items():
        s[1].FLIGHT._reset_for_tests()
        s[4].OBS.on = state[name]


def _bundles(directory) -> list:
    return sorted(n for n in os.listdir(directory)
                  if n.startswith("bundle-"))


def _manifest(path) -> dict:
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
        m = json.load(f)
    return {k: v for k, v in m.items() if k not in _CLOCK}


def _wire() -> bytes:
    e = protocol.encode()
    for i in range(30):
        e.change({"key": f"k{i}", "change": i, "from": 0, "to": 1,
                  "value": bytes([i]) * 40})
        if i == 10:
            e.blob(3000).end(b"q" * 3000)
    e.finalize()
    out = bytearray()
    while (c := e.read()) is not None:
        out += c
    return bytes(out)


WIRE = _wire()


@pytest.mark.parametrize("side", SIDES)
def test_routine_dumps_stop_at_half_the_budget(side, tmp_path):
    flight = SIDES[side][1]
    flight.FLIGHT.arm(str(tmp_path), max_bundles=6)
    routine = [flight.FLIGHT.dump("recovered", routine=True)
               for _ in range(5)]
    assert [p is not None for p in routine] == [True] * 3 + [False] * 2
    # failures keep the other half
    failures = [flight.FLIGHT.dump("protocol-error",
                                   error=RuntimeError(str(i)))
                for i in range(4)]
    assert [p is not None for p in failures] == [True] * 3 + [False]
    assert len(_bundles(tmp_path)) == 6
    assert flight.FLIGHT.suppressed == 3


def test_routine_cap_matches_jax(tmp_path):
    seen = {}
    for side in SIDES:
        flight = SIDES[side][1]
        flight.FLIGHT._reset_for_tests()
        d = tmp_path / side
        flight.FLIGHT.arm(str(d), max_bundles=5)
        out = []
        for i in range(8):
            out.append(flight.FLIGHT.dump(
                "recovered" if i % 2 else "failed",
                routine=bool(i % 2)) is not None)
        # bundle-<pid>-c<capture>-<seq>-<reason>: the capture number
        # counts the arms of this process, so only seq and reason compare
        seen[side] = (out, flight.FLIGHT.suppressed,
                      [n.split("-", 3)[3] for n in _bundles(d)])
    assert seen["port"] == seen["jax"]


def test_dump_with_checkpoint_matches_jax(tmp_path):
    ck = SessionCheckpoint(wire_offset=1234, frame=7, row=5, blob_offset=9,
                           digest={"change_seq": 5, "blob_seq": 2})
    manifests = {}
    for side in SIDES:
        flight = SIDES[side][1]
        flight.FLIGHT.arm(str(tmp_path / side))
        err = (ProtocolError if side == "port" else JProtocolError)(
            "boom", frame=7, offset=1234, cause=ValueError("x"))
        path = flight.FLIGHT.dump("session-failed", error=err,
                                  checkpoint=ck, extra={"k": 1})
        manifests[side] = _manifest(path)
        # a plain dict is taken as the checkpoint too
        manifests[side + "-dict"] = _manifest(flight.FLIGHT.dump(
            "ctx", checkpoint=ck.as_dict()))
    assert manifests["port"] == manifests["jax"]
    assert manifests["port-dict"] == manifests["jax-dict"]
    assert manifests["port"]["checkpoint"] == ck.as_dict()


@pytest.mark.parametrize("cut", [0, 1, 2], ids=["type", "length", "late"])
def test_protocol_error_bundle_carries_the_same_checkpoint(cut, tmp_path):
    bad = bytearray(WIRE)
    if cut == 0:
        bad[1] = 0x7F  # the first frame's type id: unknown
    elif cut == 1:
        bad[0:0] = b"\xff" * 12  # a varint past 64 bits
    else:
        # frame 25's type id, past the blob
        frames = list(iter_frames(WIRE))
        bad[frames[25][2] - 1] = 0x7F
    manifests = {}
    for side in SIDES:
        p, flight = SIDES[side][0], SIDES[side][1]
        flight.FLIGHT.arm(str(tmp_path / side))
        dec = p.decode()
        dec.change(lambda c, done: done())
        errors = []
        dec.on_error(errors.append)
        for i in range(0, len(bad), 97):
            if dec.destroyed:
                break
            dec.write(bytes(bad[i:i + 97]))
        assert dec.destroyed and errors
        names = _bundles(tmp_path / side)
        assert len(names) == 1 and names[0].endswith("protocol-error")
        manifests[side] = _manifest(tmp_path / side / names[0])
    assert manifests["port"] == manifests["jax"]
    ck = manifests["port"]["checkpoint"]
    assert ck["wire_offset"] == manifests["port"]["error"]["offset"]
    assert ck["frame"] == manifests["port"]["error"]["frame"]


def test_recovered_session_bundle_matches_jax(tmp_path):
    manifests = {}
    for side in SIDES:
        p, flight, faults, reconnect, _m = SIDES[side]
        flight.FLIGHT.arm(str(tmp_path / side))
        dec = p.decode()

        def source(ckpt, failures, faults=faults):
            plan = faults.FaultPlan(seed=3, drop_at=700 if failures == 0
                                    else None, max_segment=333)
            return faults.FaultyReader(
                faults.bytes_reader(WIRE[ckpt.wire_offset:]), plan,
                sleep=lambda s: None)

        stats = reconnect.run_resumable(
            source, dec, reconnect.BackoffPolicy(base=0.0, seed=1),
            expected_total=len(WIRE))
        assert dec.finished and stats["reconnects"] == 1
        names = _bundles(tmp_path / side)
        assert len(names) == 1 and names[0].endswith("recovered")
        manifests[side] = _manifest(tmp_path / side / names[0])
    assert manifests["port"] == manifests["jax"]
    m = manifests["port"]
    assert m["checkpoint"]["wire_offset"] == len(WIRE)
    assert [pl["drop_at"] for pl in m["fault_plans"]] == [700, None]
    assert m["extra"]["stats"]["attempts"] == 2


def test_a_clean_session_dumps_nothing(tmp_path):
    pflight.FLIGHT.arm(str(tmp_path))
    dec = protocol.decode()
    preconnect.run_resumable(
        lambda ck, f: pfaults.FaultyReader(
            pfaults.bytes_reader(WIRE[ck.wire_offset:]), pfaults.FaultPlan()),
        dec, preconnect.BackoffPolicy(base=0.0), expected_total=len(WIRE))
    assert dec.finished and _bundles(tmp_path) == []
