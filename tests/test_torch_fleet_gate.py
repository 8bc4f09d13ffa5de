"""Phase 19a's fleet gate of ``chip_smoke.py``, on the CPU.

``chip_smoke.run_fleet_gate`` judges recorded samples, never a live
moment: four sidecars' ``/snapshot`` records (each with its ``/healthz``
under ``healthz``) and r1's ``--stats-fd`` records, written as files.
Here those files are made with numpy, once with every target healthy and
once with r0's edge loop behind, as a sidecar rebuilding a replica on its
loop thread reports it.  The gate must give the rows and exit code the
saved records call for, through ``run_fleet_check`` and through ``python
-m dat_replication_protocol_tpu_torch.obs fleet --check`` alike, and the
JAX package's ``run_fleet_check`` must print the same over the same
files.  A sample whose digest is not the oracle's, or with a quarantined
peer, fails the phase.  ``make_blob``'s threaded pieces are the bytes of
one ``default_rng(seed).bytes(n)``.
"""

import io
import json
import os

import numpy as np
import pytest

import chip_smoke as cs
from dat_replication_protocol_tpu.obs import fleet as jfleet

WANT = "5e" * 32


def _sample(rng, i: int, behind_s=None) -> dict:
    """One sidecar's record at the settled point of a four-replica mesh;
    ``behind_s``: r0's edge loop lag, past half a tick."""
    peers = [j for j in range(cs.MESH_REPLICAS) if j != i]
    links = {f"r{i}->r{j}": {
        "round": int(rng.integers(3, 9)), "divergence_records": 0,
        "divergence_bytes": 0,
        "last_success_age_s": float(rng.uniform(0, 0.6)),
        "outcome": "converged"} for j in peers}
    loops = {}
    stages = {"backend_init": {"ok": True, "state": "idle"},
              "flight_recorder": {"ok": True, "armed": False},
              "obs_gate": {"ok": True, "on": True}}
    if i == 0:
        lag = 0.0 if behind_s is None else behind_s
        name = "edge:127.0.0.1:40000"
        loops[name] = {"state": "live", "lag_s": lag,
                       "lag_max_s": max(lag, float(rng.uniform(0, 2))),
                       "oldest_ready_s": 0.0, "turns": 400,
                       "behind": behind_s is not None}
        stages["loop_lag"] = {"ok": behind_s is None,
                              "behind": [] if behind_s is None else [name],
                              "lag_s": {name: lag}}
    return {
        "ts": float(rng.uniform(1e9, 2e9)), "monotonic": 100.0 + i,
        "emit_seq": int(rng.integers(20, 40)),
        "metrics": {"counters": {"gossip.rounds": 9}, "gauges": {}},
        "events_dropped": 0, "jit_sites": {},
        "watermarks": {"monotonic": 100.0 + i, "links": {}, "loops": loops},
        "gossip": {"replica": f"r{i}", "round": int(rng.integers(7, 11)),
                   "records": 266240, "digest": WANT, "quarantined": [],
                   "quarantine": {}, "suspicion": {}, "state": "live",
                   "exchanges_ok": 8},
        "propagation": {
            "links": links,
            "frontier": {f"r{i}": {"digest": WANT, "records": 266240,
                                   "round": int(rng.integers(2, 4))}},
            "exchange_seconds": {"p50": 0.02,
                                 "p99": float(rng.uniform(0.05, 0.5)),
                                 "count": int(rng.integers(10, 40))}},
        "healthz": {"ok": all(s["ok"] for s in stages.values()),
                    "stages": stages, "ts": 1.0, "monotonic": 100.0},
    }


def _files(tmp_path, seed: int, behind_s=None, edit=None) -> list:
    rng = np.random.default_rng(seed)
    files = []
    for i in range(cs.MESH_REPLICAS):
        rec = _sample(rng, i, behind_s)
        if edit is not None:
            edit(i, rec)
        path = tmp_path / f"r{i}.sample.jsonl"
        path.write_text(json.dumps(rec) + "\n")
        files.append(str(path))
    tee = [_sample(rng, 1) for _ in range(3)]
    for k, rec in enumerate(tee):
        rec["emit_seq"] = k
    path = tmp_path / "r1.stats.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in tee))
    files.append(str(path))
    return files


@pytest.fixture
def out_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "P19_OUT", str(tmp_path))
    return tmp_path


def _jax_check(files, slo_path) -> tuple:
    buf = io.StringIO()
    return jfleet.run_fleet_check(files, slo_path, polls=1, out=buf), \
        buf.getvalue()


def test_gate_passes_on_healthy_samples(out_dir):
    files = _files(out_dir, 1)
    gate = cs.run_fleet_gate(files, WANT)
    assert gate["rc"] == 0 and gate["r0_healthz_ok"]
    assert gate["summary"] == "fleet-check: 12 check(s), 0 failed — within SLO"
    assert {r[0] for r in gate["rows"]} == {"OK"}
    assert gate["breach"].startswith("exchange p99 ")
    slo = os.path.join(out_dir, "slo.json")
    with open(slo) as f:
        assert json.load(f)["gossip"]["max_convergence_rounds"] == 16
    rc, text = _jax_check(files, slo)
    assert rc == 0
    assert cs.check_rows(text) == (gate["rows"], gate["summary"])


def test_gate_when_r0_was_behind_is_that_fail_row_and_exit_1(out_dir):
    files = _files(out_dir, 2, behind_s=0.31)
    gate = cs.run_fleet_gate(files, WANT)
    assert gate["rc"] == 1 and not gate["r0_healthz_ok"]
    assert gate["r0_loop_lag"]["lag_s"] == {"edge:127.0.0.1:40000": 0.31}
    marks = {subject: mark for mark, subject, _ in gate["rows"]}
    assert marks.pop("require_healthz[r0.sample.jsonl]") == "FAIL"
    assert set(marks.values()) == {"OK"}
    assert dict((s, d) for _, s, d in gate["rows"])[
        "require_healthz[r0.sample.jsonl]"] == "degraded: loop_lag"
    rc, text = _jax_check(files, os.path.join(out_dir, "slo.json"))
    assert rc == 1
    assert cs.check_rows(text) == (gate["rows"], gate["summary"])


@pytest.mark.parametrize("edit,why", [
    (lambda i, r: r["gossip"].update(digest="00" * 32) if i == 2 else None,
     "r2.sample.jsonl's sample"),
    (lambda i, r: r["gossip"].update(quarantined=["r3"]) if i == 3 else None,
     "r3.sample.jsonl's sample"),
])
def test_gate_refuses_a_sample_off_the_oracle(out_dir, edit, why):
    files = _files(out_dir, 3, edit=edit)
    with pytest.raises(AssertionError, match=why):
        cs.run_fleet_gate(files, WANT)


def test_gate_rows_follow_the_saved_verdict(out_dir):
    # r1's record says not ok though every stage it lists is: the row is
    # the record's verdict, FAIL, and the exit 1
    def edit(i, rec):
        if i == 1:
            rec["healthz"]["ok"] = False

    files = _files(out_dir, 4, edit=edit)
    gate = cs.run_fleet_gate(files, WANT)
    assert gate["rc"] == 1
    assert ("FAIL", "require_healthz[r1.sample.jsonl]") in \
        [r[:2] for r in gate["rows"]]


@pytest.mark.parametrize("n", [1, 100, (1 << 16) + 13, 3 * (1 << 16) + 8])
def test_make_blob_is_the_generators_bytes(n, monkeypatch):
    monkeypatch.setattr(cs, "BLOB_PIECE", 1 << 16)
    want = np.frombuffer(np.random.default_rng(cs.SEED + 20).bytes(n),
                         dtype=np.uint8)
    assert np.array_equal(cs.make_blob(n), want)


def test_stats_reader_drains_the_pipe_before_the_sidecar_listens():
    """A sidecar's stats emitter writes non-blocking and latches dead on a
    record it cannot finish within 2 s; 18b's readers start before any
    sidecar listens, so records written during a slow start all arrive
    (a 64 KiB pipe holds about 13 of these)."""
    from dat_replication_protocol_tpu_torch.sidecar import StatsEmitter

    reader = cs.StatsReader()
    emitter = StatsEmitter(reader.w, interval=3600)
    try:
        assert all(emitter.dump_once() for _ in range(40))
    finally:
        reader.start()
        reader.close()
    assert reader.errors == []
    assert [r["emit_seq"] for r in reader.records] == list(range(40))
