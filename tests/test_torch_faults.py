"""The port's fault injector against the JAX package's.

For the same seeds and wire lengths every scenario generator must give
field-equal plans in both packages (the cluster sweeps reuse them), and a
``FaultyReader`` / ``FaultyWriter`` over the same bytes and plan must
yield the same chunk sequence, sleep the same pauses and raise at the
same offset.
"""

import dataclasses

import numpy as np
import pytest

from dat_replication_protocol_tpu.session import faults as jf
from dat_replication_protocol_tpu_torch.session import faults as pf

WIRE_LENS = (1, 37, 4096, 100_003)


def _plan(mod_plan):
    return dataclasses.asdict(mod_plan)


@pytest.mark.parametrize("wire_len", WIRE_LENS)
def test_for_sweep_plans_are_field_equal(wire_len):
    for seed in range(64):
        for attempt in range(3):
            assert (_plan(pf.FaultPlan.for_sweep(seed, wire_len, attempt))
                    == _plan(jf.FaultPlan.for_sweep(seed, wire_len,
                                                    attempt)))


@pytest.mark.parametrize("wire_len", WIRE_LENS)
def test_session_axis_plans_are_field_equal(wire_len):
    for seed in range(64):
        for session in range(8):
            for attempt in range(2):
                kw = dict(session=session, n_sessions=8)
                assert (_plan(pf.FaultPlan.for_sweep(seed, wire_len,
                                                     attempt, **kw))
                        == _plan(jf.FaultPlan.for_sweep(seed, wire_len,
                                                        attempt, **kw)))
        assert (pf.FaultPlan.faulty_session(seed, 8)
                == jf.FaultPlan.faulty_session(seed, 8))
        assert (pf.FaultPlan.session_scenario(seed, 8)
                == jf.FaultPlan.session_scenario(seed, 8))


@pytest.mark.parametrize("n_replicas", [2, 3, 4, 7])
def test_partition_and_link_axes_are_field_equal(n_replicas):
    links = [(a, b) for a in range(n_replicas) for b in range(n_replicas)
             if a != b]
    for seed in range(64):
        assert (pf.FaultPlan.partition_scenario(seed, n_replicas)
                == jf.FaultPlan.partition_scenario(seed, n_replicas))
        for link in links:
            assert (pf.FaultPlan.link_scenario(seed, n_replicas, link)
                    == jf.FaultPlan.link_scenario(seed, n_replicas, link))
            for rnd in (0, 2, 5, 9):
                assert (pf.FaultPlan.partitioned(seed, n_replicas, link, rnd)
                        == jf.FaultPlan.partitioned(seed, n_replicas, link,
                                                    rnd))
                kw = dict(link=link, n_replicas=n_replicas,
                          gossip_round=rnd)
                assert (_plan(pf.FaultPlan.for_sweep(seed, 4096, **kw))
                        == _plan(jf.FaultPlan.for_sweep(seed, 4096, **kw)))


def test_scenario_vocabularies_match():
    for name in ("SWEEP_SCENARIOS", "SESSION_SCENARIOS", "LINK_SCENARIOS"):
        assert getattr(pf.FaultPlan, name) == getattr(jf.FaultPlan, name)


def _wire(seed: int, n: int = 5000) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def _read_all(mod, data: bytes, plan_kw: dict, sizes) -> list:
    """Pull through a FaultyReader with a read-size schedule: the chunks,
    the sleeps asked for, and how it ended (EOF offset or the fault)."""
    sleeps = []
    r = mod.FaultyReader(mod.bytes_reader(data), mod.FaultPlan(**plan_kw),
                         sleep=sleeps.append)
    out = []
    i = 0
    while True:
        try:
            chunk = r.read(int(sizes[i % len(sizes)]))
        except mod.TransportFault as e:
            out.append(("fault", str(e), e.offset))
            break
        i += 1
        if not chunk:
            out.append(("eof", r.offset))
            break
        out.append(chunk)
    return out + [("sleeps", sleeps)]


def _sweep_kw(seed: int, n: int, attempt: int) -> dict:
    return _plan(pf.FaultPlan.for_sweep(seed, n, attempt))


@pytest.mark.parametrize("seed", range(16))
def test_faulty_reader_chunks_and_faults_match(seed):
    data = _wire(seed)
    sizes = np.random.default_rng(seed + 100).integers(1, 700, 16).tolist()
    for attempt in range(3):
        kw = _sweep_kw(seed, len(data), attempt)
        assert (_read_all(pf, data, kw, sizes)
                == _read_all(jf, data, kw, sizes))


@pytest.mark.parametrize("kw", [
    dict(seed=3, flip_at=10, flip_mask=0x40),
    dict(seed=4, drop_at=0),
    dict(seed=5, truncate_at=4999, max_segment=7),
    dict(seed=6, stall_at=100, stall_s=0.5, latency_prob=0.3,
         latency_s=0.01, max_segment=64),
    dict(seed=7, drop_at=2500, flip_at=2499, max_segment=1),
], ids=["flip", "drop-at-0", "truncate-last", "stall-latency",
        "flip-before-drop"])
def test_faulty_reader_targeted_plans_match(kw):
    data = _wire(kw["seed"])
    sizes = [64, 1, 4096, 333]
    got = _read_all(pf, data, kw, sizes)
    assert got == _read_all(jf, data, kw, sizes)
    flat = b"".join(c for c in got if isinstance(c, bytes))
    if "flip_at" in kw and kw["flip_at"] < len(flat):
        mask = kw.get("flip_mask", 0xFF)
        assert flat[kw["flip_at"]] == data[kw["flip_at"]] ^ mask


def _write_all(mod, data: bytes, plan_kw: dict, pieces) -> list:
    sleeps = []
    out = []
    w = mod.FaultyWriter(out.append, mod.FaultPlan(**plan_kw),
                         sleep=sleeps.append)
    i = 0
    end = None
    for n in pieces:
        try:
            w.write(data[i:i + n])
        except mod.TransportFault as e:
            end = ("fault", str(e), e.offset)
            break
        i += n
    return out + [end, ("offset", w.offset), ("sleeps", sleeps)]


@pytest.mark.parametrize("seed", range(16))
def test_faulty_writer_segments_and_faults_match(seed):
    data = _wire(seed + 50)
    cut = np.sort(np.random.default_rng(seed).integers(0, len(data), 7))
    pieces = np.diff(np.concatenate([[0], cut, [len(data)]])).tolist()
    for attempt in range(3):
        kw = _sweep_kw(seed, len(data), attempt)
        assert (_write_all(pf, data, kw, pieces)
                == _write_all(jf, data, kw, pieces))
